"""Generic device chunk-streaming: derived hooks for static wave-chain
plugins (plugins/device_stream.py).

Round-3's device chunk executor needed hand-written device_chunk_* hooks
(one plugin had them); these tests pin the round-4 generalization — any
static plugin exposing the two-phase kernel interface streams on the mesh
via StreamingContext.get_stream(..., executor_type="device") — against the
host serial engine chunk-for-chunk (reference genericity bar:
waveform_analysis/core/plugins/core/streaming.py:740-880).
"""

import numpy as np
import pytest

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.plugins.device_stream import DeviceKernelStream
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.plugins.streaming import (
    StreamingConfig,
    StreamingContext,
)
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

DEVICE_NAMES = ["basic_features", "hit", "hit_threshold",
                "waveform_width_integral"]


def _ctx(tmp_path, n=40):
    ctx = Context(storage_dir=str(tmp_path / "s"),
                  config={"show_progress": False})
    ctx.register(*default_plugins())
    st = make_fake_st_waveforms(
        n_events=n, wave_length=64, n_channels=2, pulse_start=20,
        pulse_width=6, pulse_height=250, noise_rms=2.0, seed=7,
    )
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


def _tables_equal(a, b, msg=""):
    a = a.to_numpy() if hasattr(a, "to_numpy") else np.asarray(a)
    b = b.to_numpy() if hasattr(b, "to_numpy") else np.asarray(b)
    assert a.dtype == b.dtype, f"{msg}: dtype"
    assert len(a) == len(b), f"{msg}: length {len(a)} vs {len(b)}"
    for f in a.dtype.names:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}.{f}")


@pytest.mark.multidevice
@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_device_stream_matches_host_serial(tmp_path, name):
    """Chunk-for-chunk bit parity: mesh-sharded executor vs host serial
    engine over identical chunks."""
    ctx = _ctx(tmp_path)
    sc = StreamingContext(ctx)

    device_chunks = list(sc.get_stream(
        "r", name, chunk_size=8, executor_type="device"
    ))
    assert len(device_chunks) > 1  # really chunked

    adapter = DeviceKernelStream.for_data_name(ctx, name)
    cfg = StreamingConfig.resolve(ctx, adapter)
    cfg.chunk_size = 8
    host_chunks = list(adapter._compute_serial(
        ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg
    ))

    assert len(device_chunks) == len(host_chunks)
    for i, (d, h) in enumerate(zip(device_chunks, host_chunks)):
        assert (d.start, d.end) == (h.start, h.end)
        _tables_equal(d.data, h.data, msg=f"{name}[chunk {i}]")


@pytest.mark.multidevice
def test_device_stream_identity_is_global(tmp_path):
    """event_index / record_id in streamed outputs are the SOURCE row ids,
    not chunk-local indices."""
    ctx = _ctx(tmp_path)
    sc = StreamingContext(ctx)
    merged = sc.merge_stream(
        sc.get_stream("r", "basic_features", chunk_size=8,
                      executor_type="device"),
        sort=False,
    )
    arr = merged.to_numpy() if hasattr(merged, "to_numpy") else merged
    # source rows are unique records: ids must be globally unique
    ids = np.sort(arr["event_index"])
    assert len(np.unique(ids)) == len(ids)
    st = ctx.get_data("r", "st_waveforms")
    st = st.to_numpy() if hasattr(st, "to_numpy") else st
    assert set(ids.tolist()) == set(st["record_id"].tolist())


@pytest.mark.multidevice
@pytest.mark.parametrize("name", ["basic_features", "waveform_width_integral"])
def test_device_stream_merged_matches_static(tmp_path, name):
    """Merging the device stream reproduces the static compute's row set
    (event-level members: every output row's timestamp equals its source
    event's, so time chunking partitions rows exactly)."""
    ctx = _ctx(tmp_path)
    static = ctx.get_data("r", name)
    static = static.to_numpy() if hasattr(static, "to_numpy") else static

    sc = StreamingContext(ctx)
    merged = sc.merge_stream(
        sc.get_stream("r", name, chunk_size=8, executor_type="device"),
        sort=False,
    )
    arr = merged.to_numpy() if hasattr(merged, "to_numpy") else merged
    assert len(arr) == len(static)
    key = np.argsort(arr["event_index"], kind="stable")
    skey = np.argsort(static["event_index"], kind="stable")
    a, s = arr[key], static[skey]
    for f in s.dtype.names:
        np.testing.assert_array_equal(a[f], s[f], err_msg=f"{name}.{f}")


@pytest.mark.multidevice
def test_device_stream_hits_merged_matches_static_with_halo(tmp_path):
    """Hit rows can carry timestamps past their source chunk's window
    (ts = event ts + position*dt); a left halo covering the wave duration
    makes the time partition exact vs the static compute."""
    ctx = _ctx(tmp_path)
    static = ctx.get_data("r", "hit")
    static = static.to_numpy() if hasattr(static, "to_numpy") else static

    sc = StreamingContext(ctx)
    merged = sc.merge_stream(
        sc.get_stream("r", "hit", chunk_size=8, executor_type="device",
                      required_halo_left_ns=200.0),
        sort=False,
    )
    arr = merged.to_numpy() if hasattr(merged, "to_numpy") else merged
    assert len(arr) == len(static)
    key = np.lexsort((arr["position"], arr["record_id"]))
    skey = np.lexsort((static["position"], static["record_id"]))
    a, s = arr[key], static[skey]
    for f in s.dtype.names:
        np.testing.assert_array_equal(a[f], s[f], err_msg=f"hit.{f}")


def test_unknown_name_falls_back_to_host_view(tmp_path, caplog):
    """st_waveforms has no derivable hooks: device request warns and serves
    the host chunk view."""
    import logging

    ctx = _ctx(tmp_path, n=12)
    sc = StreamingContext(ctx)
    with caplog.at_level(logging.WARNING):
        chunks = list(sc.get_stream("r", "st_waveforms", chunk_size=6,
                                    executor_type="device"))
    assert any("no derivable device hooks" in r.message for r in caplog.records)
    assert sum(len(c) for c in chunks) == 12


def test_for_data_name_rejects_overridden_compute(tmp_path):
    ctx = _ctx(tmp_path, n=4)
    assert DeviceKernelStream.for_data_name(ctx, "df") is None
    assert DeviceKernelStream.for_data_name(ctx, "basic_features") is not None
