"""Multi-device parity checks: the sharded paths against one device.

One ``data`` axis over all devices (the mesh follows the algorithm: events
are independent, so they shard on the batch axis). Each check runs a
mesh path — the sharded chain step, halo exchange, a mesh-attached
Context's fused bundle and batched multi-run dispatch, the device chunk
stream executors, columnar events with device pair_events, the sharded
time-sorted merge — and asserts it equals the single-device result bit for
bit. Run on the virtual CPU mesh by ``__graft_entry__.py --multichip N``
and on real cards by ``chip_smoke.py --cards 4``.
"""

from __future__ import annotations

import tempfile
from typing import Callable, Dict

import numpy as np


def _have_pandas() -> bool:
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    return True


def _assert_tables_equal(a, b, what: str) -> None:
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows"
    for f in b.field_names:
        assert np.array_equal(np.asarray(a[f]), np.asarray(b[f])), \
            f"{what}.{f} differs"


def run_mesh_checks(
    n_devices: int,
    events_per_device: int = 16,
    wave_length: int = 128,
    chunk_size: int = 16,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """Run every parity family on an n_devices ``data`` mesh; returns a
    summary dict. Raises AssertionError on the first mismatch."""
    import jax
    import jax.numpy as jnp

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.models.full_chain import (
        ChainConfig,
        example_chain_batch,
        full_chain_step,
        make_sharded_chain,
    )
    from waveformanalysis_tpu.parallel.mesh import data_sharding, make_mesh
    from waveformanalysis_tpu.parallel.scan import (
        make_sharded_pipeline,
        shard_table_arrays,
    )
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

    summary: Dict[str, object] = {"devices": n_devices}
    mesh = make_mesh(n_devices=n_devices, axis_names=("data",))
    pandas = _have_pandas()

    # ---- the sharded chain step -------------------------------------------
    cfg = ChainConfig(use_derivative=False, peak_height=80.0,
                      peak_prominence=50.0, peak_width=2.0)
    n_events = events_per_device * n_devices
    batch = example_chain_batch(n_events=n_events, wave_length=wave_length)
    sharded = tuple(jax.device_put(x, data_sharding(mesh)) for x in batch)
    out = {k: np.asarray(v)
           for k, v in make_sharded_chain(mesh, cfg)(*sharded).items()}
    one = tuple(jax.device_put(x, jax.devices()[0]) for x in batch)
    single = {k: np.asarray(v) for k, v in
              jax.jit(lambda *a: full_chain_step(*a, cfg))(*one).items()}
    for k, v in single.items():
        assert np.array_equal(out[k], v), f"sharded vs one-device chain.{k}"
    n_s1, n_s2 = int(out["n_s1"]), int(out["n_s2"])
    assert n_s1 == int(np.sum(single["label"] == 1)), "psum n_s1"
    assert n_s2 == int(np.sum(single["label"] == 2)), "psum n_s2"
    assert np.isclose(out["total_area"], single["area"].sum(), rtol=1e-5), \
        "psum total_area"
    assert n_s1 + n_s2 > 0, "sharded chain classified nothing"
    summary.update(chain_events=n_events, n_s1=n_s1, n_s2=n_s2)
    log(f"sharded chain ok: {n_events} events equal to one device, "
        f"S1={n_s1} S2={n_s2}")

    # ---- halo exchange: 3-point smoothing across shard boundaries ---------
    def halo_kernel(x, left_halo=None, right_halo=None):
        ext = jnp.concatenate([left_halo, x, right_halo])
        return {"smooth": ext[:-2] + ext[1:-1] + ext[2:],
                "total": jnp.sum(x)}

    fn = make_sharded_pipeline(
        mesh, halo_kernel, n_inputs=1,
        out_keys=("smooth", "total"), stats_keys=("total",), halo=1,
    )
    x = np.arange(n_devices * 8, dtype=np.float32)
    (xs,) = shard_table_arrays(mesh, x)
    assert np.allclose(np.asarray(fn(xs)["smooth"]),
                       np.convolve(x, [1, 1, 1], "same")), \
        "ppermute halo exchange produced wrong boundaries"
    log("halo exchange ok")

    # ---- a mesh-attached Context vs the single-device Context -------------
    st = make_fake_st_waveforms(
        n_events=n_events + 5,  # non-multiple: exercises pad/unpad
        wave_length=wave_length, pulse_height=300, polarity="positive",
    )
    hit_cfg = {"use_filtered": False, "use_derivative": False,
               "height": 100.0, "prominence": 50.0, "width": 2}

    from waveformanalysis_tpu.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.dataframe import (
        DataFramePlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.event_analysis import (
        GroupedEventsPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.hit_finder import (
        ThresholdHitPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.peak_finding import (
        HitFinderPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.s1_s2_classifier import (
        S1S2ClassifierPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.waveform_width import (
        WaveformWidthPlugin,
    )

    def mk_ctx(tmp, on_mesh):
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(
            BasicFeaturesPlugin(), HitFinderPlugin(), ThresholdHitPlugin(),
            WaveformWidthPlugin(), S1S2ClassifierPlugin(),
            DataFramePlugin(), GroupedEventsPlugin(),
        )
        ctx.set_config({
            "hit": hit_cfg,
            "s1_s2": {"s1_width_range": (0.0, 30.0),
                      "s2_width_range": (40.0, 10000.0)},
            "df_events": {"grouping_backend": "device"},
        })
        if on_mesh:
            ctx.attach_mesh(mesh)
        return ctx

    with tempfile.TemporaryDirectory() as tmp_m, \
            tempfile.TemporaryDirectory() as tmp_s:
        ctx_mesh, ctx_single = mk_ctx(tmp_m, True), mk_ctx(tmp_s, False)
        for ctx in (ctx_mesh, ctx_single):
            ctx.inject_data("run", "st_waveforms", st)
        s1s2_m = ctx_mesh.get_data("run", "s1_s2")
        s1s2_s = ctx_single.get_data("run", "s1_s2")
        assert len(s1s2_s) > 0, "mesh Context chain empty"
        _assert_tables_equal(s1s2_m, s1s2_s, "mesh vs single s1_s2")
        if pandas:
            ev_m = ctx_mesh.get_data("run", "df_events")
            ev_s = ctx_single.get_data("run", "df_events")
            assert len(ev_m) == len(ev_s) > 0
            assert np.array_equal(np.asarray(ev_m["t_min"]),
                                  np.asarray(ev_s["t_min"])), \
                "device event grouping mismatch on the mesh Context"
        assert ctx_mesh.key_for("run", "s1_s2") == \
            ctx_single.key_for("run", "s1_s2"), \
            "mesh attachment must not change lineage keys"
        # cache cycle on the mesh context: cloned re-read hits the cache
        ctx2 = ctx_mesh.clone()
        ctx2.inject_data("run", "st_waveforms", st)
        assert len(ctx2.get_data("run", "s1_s2")) == len(s1s2_m)
        # batched multi-run dispatch on the mesh: per-run outputs equal the
        # single-device per-run path
        st_b = make_fake_st_waveforms(
            n_events=n_events // 2 + 3, wave_length=wave_length,
            pulse_height=300, polarity="positive", seed=5,
        )
        for ctx in (ctx_mesh, ctx_single):
            ctx.inject_data("run_b", "st_waveforms", st_b)
        batched = ctx_mesh.get_data_batched(["run", "run_b"],
                                            ["basic_features", "hit"])
        for rid in ("run", "run_b"):
            for name in ("basic_features", "hit"):
                _assert_tables_equal(batched[rid][name],
                                     ctx_single.get_data(rid, name),
                                     f"batched-on-mesh {rid}.{name}")
        for c in (ctx_mesh, ctx_single, ctx2):
            c.flush_saves()
    summary["context_s1_s2_rows"] = len(s1s2_m)
    log(f"mesh Context ok: {len(s1s2_m)} s1_s2 rows, batched multi-run ok"
        f"{'' if pandas else ' (df_events skipped: no pandas)'}")

    # ---- device chunk stream executor vs the host chunk executor ----------
    from waveformanalysis_tpu.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin,
    )

    with tempfile.TemporaryDirectory() as tmp_h, \
            tempfile.TemporaryDirectory() as tmp_d:
        def mk_stream_ctx(tmp, stream_cfg, on_mesh):
            ctx = Context(storage_dir=tmp, config={"show_progress": False})
            ctx.register(SignalPeaksStreamPlugin())
            ctx.set_config({"signal_peaks_stream": {
                "height": 50.0, "prominence": 10.0, "width": 1,
                "streaming_config": stream_cfg,
            }})
            if on_mesh:
                ctx.attach_mesh(mesh)
            ctx.inject_data("run", "st_waveforms", st)
            return ctx

        ctx_h = mk_stream_ctx(tmp_h, {"chunk_size": chunk_size}, False)
        ctx_d = mk_stream_ctx(
            tmp_d, {"chunk_size": chunk_size, "executor_type": "device"},
            True)
        host_chunks = list(ctx_h.get_data("run", "signal_peaks_stream"))
        dev_chunks = list(ctx_d.get_data("run", "signal_peaks_stream"))
        assert len(host_chunks) == len(dev_chunks) > 0
        n_stream_hits = 0
        for hc, dc in zip(host_chunks, dev_chunks):
            assert (hc.start, hc.end) == (dc.start, dc.end)
            _assert_tables_equal(dc.data, hc.data, "device chunk executor")
            n_stream_hits += len(dc)
        assert n_stream_hits > 0, "device chunk executor found no hits"
    summary["stream_chunks"] = len(dev_chunks)
    log(f"device chunk stream ok: {len(dev_chunks)} chunks, "
        f"{n_stream_hits} hits")

    # ---- generic device chunk streams (derived hooks) ---------------------
    from waveformanalysis_tpu.plugins.device_stream import (
        DEVICE_STREAM_GLUE,
        DeviceKernelStream,
    )
    from waveformanalysis_tpu.plugins.streaming import (
        StreamingConfig,
        StreamingContext,
    )

    derived = []
    with tempfile.TemporaryDirectory() as tmp_g:
        ctx_g = Context(storage_dir=tmp_g, config={"show_progress": False})
        ctx_g.register(*default_plugins())
        ctx_g.attach_mesh(mesh)
        ctx_g.inject_data("run", "st_waveforms", st)
        sc = StreamingContext(ctx_g)
        for name in sorted(DEVICE_STREAM_GLUE):
            dev_stream = list(sc.get_stream(
                "run", name, chunk_size=chunk_size, executor_type="device"))
            adapter = DeviceKernelStream.for_data_name(ctx_g, name)
            assert adapter is not None, name
            s_cfg = StreamingConfig.resolve(ctx_g, adapter)
            s_cfg.chunk_size = chunk_size
            host_stream = list(adapter._compute_serial(
                ctx_g, "run", adapter.input_stream(ctx_g, "run", s_cfg),
                s_cfg))
            assert len(dev_stream) == len(host_stream) > 0, name
            for hc, dc in zip(host_stream, dev_stream):
                assert (hc.start, hc.end) == (dc.start, dc.end)
                _assert_tables_equal(dc.data, hc.data,
                                     f"derived device stream {name}")
            derived.append(name)
    summary["derived_streams"] = derived
    log(f"derived device streams ok: {', '.join(derived)}")

    # ---- columnar events + device pair_events vs host grouping ------------
    def mk_events_ctx(tmp, backend, on_mesh):
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(*default_plugins())
        ctx.set_config({
            "hit": hit_cfg,
            "events": {"grouping_backend": backend},
            "event_hits": {"grouping_backend": backend},
            "df_events": {"grouping_backend": backend},
            "df_paired": {"grouping_backend": backend,
                          "events_source": "columnar"},
        })
        if on_mesh:
            ctx.attach_mesh(mesh)
        ctx.inject_data("run", "st_waveforms", st)
        return ctx

    with tempfile.TemporaryDirectory() as tmp_ed, \
            tempfile.TemporaryDirectory() as tmp_eh:
        ctx_ed = mk_events_ctx(tmp_ed, "device", True)
        ctx_eh = mk_events_ctx(tmp_eh, "host", False)
        for name in ("events", "event_hits"):
            t_h = ctx_eh.get_data("run", name)
            assert len(t_h) > 0, f"columnar {name} empty"
            _assert_tables_equal(ctx_ed.get_data("run", name), t_h,
                                 f"columnar-on-mesh {name}")
        n_paired = None
        if pandas:
            paired_d = ctx_ed.get_data("run", "df_paired")
            paired_h = ctx_eh.get_data("run", "df_paired")
            assert len(paired_d) == len(paired_h) > 0, "df_paired empty"
            assert list(paired_d.columns) == list(paired_h.columns)
            for col in paired_h.columns:
                a, b = np.asarray(paired_d[col]), np.asarray(paired_h[col])
                eq = (np.array_equal(a, b, equal_nan=True)
                      if a.dtype.kind == "f" else np.array_equal(a, b))
                assert eq, f"device pair_events mismatch in df_paired.{col}"
            n_paired = len(paired_d)
        summary["events"] = len(ctx_ed.get_data("run", "events"))
        for c in (ctx_ed, ctx_eh):
            c.flush_saves()
    summary["paired_rows"] = n_paired
    log(f"columnar events ok: {summary['events']} events; df_paired "
        f"{'skipped: no pandas' if n_paired is None else f'{n_paired} rows'}")

    # ---- distributed time-sorted merge vs host lexsort --------------------
    from waveformanalysis_tpu.parallel.sorted_merge import sharded_time_sort

    rng = np.random.default_rng(1)
    n_rows = n_events + 11
    cols = {
        "timestamp": rng.integers(10**14, 10**15, n_rows).astype(np.int64),
        "record_id": np.arange(n_rows, dtype=np.int64),
    }
    merged = sharded_time_sort(cols, ("timestamp", "record_id"), mesh)
    host_order = np.lexsort((cols["record_id"], cols["timestamp"]))
    assert np.array_equal(merged["timestamp"], cols["timestamp"][host_order]), \
        "sharded odd-even merge disagrees with host lexsort"
    summary["sorted_rows"] = n_rows
    log(f"sharded sorted merge ok: {n_rows} rows")
    return summary
