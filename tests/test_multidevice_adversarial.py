"""Adversarial multi-device cases (VERDICT r3 item 8): degenerate meshes,
empty shards, cross-shard break segments, uneven final groups, and
mesh-sharded fused bundles overflowing slot capacity."""

import logging

import numpy as np
import pytest

import jax

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.dtypes.chunk import Chunk
from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.parallel.mesh import make_mesh
from waveformanalysis_tpu.plugins.device_stream import DeviceKernelStream
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.plugins.streaming import (
    StreamingConfig,
    StreamingContext,
)
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

pytestmark = pytest.mark.multidevice


def _ctx(tmp_path, sub="s", st=None, mesh=None, config=None):
    cfg = {"show_progress": False}
    cfg.update(config or {})
    ctx = Context(storage_dir=str(tmp_path / sub), config=cfg)
    ctx.register(*default_plugins())
    if mesh is not None:
        ctx.attach_mesh(mesh)
    if st is None:
        st = make_fake_st_waveforms(
            n_events=40, wave_length=64, n_channels=2, pulse_start=20,
            pulse_width=6, pulse_height=250, noise_rms=2.0, seed=3,
        )
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


def _table_equal(a, b, msg=""):
    a = a.to_numpy() if hasattr(a, "to_numpy") else np.asarray(a)
    b = b.to_numpy() if hasattr(b, "to_numpy") else np.asarray(b)
    assert len(a) == len(b), f"{msg}: {len(a)} vs {len(b)}"
    for f in a.dtype.names:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}.{f}")


def _require(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")


class TestDegenerateMesh:
    def test_one_device_mesh_fused_bundle(self, tmp_path):
        """A 1-device mesh must behave exactly like no mesh."""
        mesh = make_mesh(1)
        ref = _ctx(tmp_path, "plain")
        dev = _ctx(tmp_path, "mesh1", mesh=mesh)
        for name in ("basic_features", "hit_threshold", "s1_s2"):
            _table_equal(ref.get_data("r", name), dev.get_data("r", name),
                         msg=f"mesh1.{name}")

    def test_one_device_mesh_chunk_stream(self, tmp_path):
        mesh = make_mesh(1)
        ctx = _ctx(tmp_path, "mesh1s", mesh=mesh)
        sc = StreamingContext(ctx)
        chunks = list(sc.get_stream("r", "basic_features", chunk_size=8,
                                    executor_type="device"))
        total = sum(len(c) for c in chunks)
        assert total == 40

    def test_fused_bundle_fewer_events_than_devices(self, tmp_path):
        """n < n_devices: pad shards are fully empty."""
        _require(8)
        mesh = make_mesh(8)
        st = make_fake_st_waveforms(n_events=3, wave_length=64,
                                    pulse_start=20, pulse_height=250)
        ref = _ctx(tmp_path, "tiny_ref", st=st)
        dev = _ctx(tmp_path, "tiny_dev", st=st, mesh=mesh)
        for name in ("basic_features", "hit"):
            _table_equal(ref.get_data("r", name), dev.get_data("r", name),
                         msg=f"tiny.{name}")


class TestEmptyShards:
    def test_zero_row_chunk_in_device_group(self, tmp_path):
        """A chunk whose rows all clipped away still round-trips the mesh
        executor (its shard computes on pure padding)."""
        _require(4)
        ctx = _ctx(tmp_path)
        adapter = DeviceKernelStream.for_data_name(ctx, "basic_features")
        cfg = StreamingConfig.resolve(ctx, adapter)
        cfg.chunk_size = 8
        chunks = list(adapter.input_stream(ctx, "r", cfg))
        assert len(chunks) >= 3
        # splice in a zero-row chunk between real ones (window inside a gap)
        donor = chunks[1]
        empty = Chunk(
            donor.data[0:0], start=donor.start, end=donor.start,
            run_id=donor.run_id, data_type=donor.data_type,
            time_field=donor.time_field, dt_field=donor.dt_field,
            length_field=donor.length_field,
            endtime_field=donor.endtime_field, dt=donor.dt,
            metadata=dict(donor.metadata),
        )
        spliced = [chunks[0], empty] + chunks[1:]

        dev_out = list(adapter._compute_device(
            ctx, "r", iter(spliced), cfg
        ))
        host_out = list(adapter._compute_serial(
            ctx, "r", iter(spliced), cfg
        ))
        assert len(dev_out) == len(host_out)
        for i, (d, h) in enumerate(zip(dev_out, host_out)):
            _table_equal(d.data, h.data, msg=f"spliced[{i}]")
        # outputs: one empty chunk, rest real
        assert sum(1 for c in dev_out if len(c) == 0) >= 1


class TestBreakSegments:
    def test_cross_shard_break_segments(self, tmp_path):
        """A time gap splits segments; chunks from different segments share
        one device group and must still match the host engine."""
        _require(4)
        st = make_fake_st_waveforms(
            n_events=32, wave_length=64, n_channels=2, pulse_start=20,
            pulse_width=6, pulse_height=250, noise_rms=2.0, seed=5,
        )
        # open a gap far beyond the break threshold between rows 16 and 17
        st = st.copy()
        st["timestamp"][16:] += np.int64(5e13)
        ctx = _ctx(tmp_path, "brk", st=st)
        adapter = DeviceKernelStream.for_data_name(ctx, "hit_threshold")
        cfg = StreamingConfig.resolve(ctx, adapter)
        cfg.chunk_size = 6
        cfg.break_threshold_ps = 1e13

        dev_out = list(adapter._compute_device(
            ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg
        ))
        host_out = list(adapter._compute_serial(
            ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg
        ))
        segs = {c.metadata.get("segment_id") for c in dev_out}
        assert len(segs) >= 2, "gap did not split segments"
        assert len(dev_out) == len(host_out)
        for i, (d, h) in enumerate(zip(dev_out, host_out)):
            assert d.metadata.get("segment_id") == h.metadata.get("segment_id")
            _table_equal(d.data, h.data, msg=f"brk[{i}]")


class TestUnevenFinalGroup:
    def test_final_group_missing_most_shards(self, tmp_path):
        """8-device mesh, 9 chunks: the final group carries 1 chunk and 7
        missing shards."""
        _require(8)
        mesh = make_mesh(8)
        st = make_fake_st_waveforms(
            n_events=36, wave_length=64, n_channels=2, pulse_start=20,
            pulse_width=6, pulse_height=250, noise_rms=2.0, seed=6,
        )
        ctx = _ctx(tmp_path, "uneven", st=st, mesh=mesh)
        adapter = DeviceKernelStream.for_data_name(ctx, "basic_features")
        cfg = StreamingConfig.resolve(ctx, adapter)
        cfg.chunk_size = 4  # 36/4 = 9 chunks over 8 shards
        dev_out = list(adapter._compute_device(
            ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg
        ))
        host_out = list(adapter._compute_serial(
            ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg
        ))
        assert len(dev_out) == len(host_out) == 9
        for i, (d, h) in enumerate(zip(dev_out, host_out)):
            _table_equal(d.data, h.data, msg=f"uneven[{i}]")


class TestMeshOverflow:
    def _multi_pulse_st(self, n=24):
        """Waveforms with 4 well-separated pulses each."""
        st = make_fake_st_waveforms(n_events=n, wave_length=128,
                                    pulse_start=10, pulse_width=4,
                                    pulse_height=300)
        st = st.copy()
        waves = st["wave"].astype(np.int64)
        for off in (40, 70, 100):
            waves[:, off:off + 4] -= 300
        st["wave"] = np.clip(waves, -32768, 32767).astype(np.int16)
        return st

    def test_mesh_fused_overflow_raise(self, tmp_path):
        _require(4)
        mesh = make_mesh(4)
        ctx = _ctx(tmp_path, "ovf_r", st=self._multi_pulse_st(), mesh=mesh,
                   config={"capacity_hints": False})
        ctx.set_config({"hit_threshold": {"max_hits_per_waveform": 2,
                                          "overflow_policy": "raise"}})
        with pytest.raises(ValueError, match="exceeded"):
            ctx.get_data("r", "hit_threshold")

    def test_mesh_fused_overflow_warn_matches_single(self, tmp_path, caplog):
        """overflow_policy=warn on the mesh: psum'd overflow counters warn,
        outputs equal the unmeshed path bit-for-bit."""
        _require(4)
        mesh = make_mesh(4)
        st = self._multi_pulse_st()
        cfgs = {"hit_threshold": {"max_hits_per_waveform": 2,
                                  "overflow_policy": "warn"}}
        ref = _ctx(tmp_path, "ovf_ref", st=st,
                   config={"capacity_hints": False})
        ref.set_config(cfgs)
        dev = _ctx(tmp_path, "ovf_dev", st=st, mesh=mesh,
                   config={"capacity_hints": False})
        dev.set_config(cfgs)
        with caplog.at_level(logging.WARNING):
            got = dev.get_data("r", "hit_threshold")
        want = ref.get_data("r", "hit_threshold")
        assert any("exceeded" in r.message for r in caplog.records)
        _table_equal(want, got, msg="mesh_overflow_warn")


class TestEventConeOnMesh:
    """Columnar events/event_hits + the device pair_events kernel under a
    mesh-attached Context (VERDICT r4 item 6): device grouping backends on
    the mesh must match the unmeshed host oracle bit-for-bit, including
    NaN fill where events have fewer hits than channels, and degenerate
    windows must produce clean empties."""

    def _pair(self, tmp_path, st, extra=None):
        _require(8)
        mesh = make_mesh(8)
        cfgs = {
            "events": {"grouping_backend": "device"},
            "event_hits": {"grouping_backend": "device"},
            "df_events": {"grouping_backend": "device"},
            "df_paired": {"grouping_backend": "device",
                          "events_source": "columnar"},
        }
        if extra:
            for k, v in extra.items():
                cfgs.setdefault(k, {}).update(v)
        host = _ctx(tmp_path, "ev_host", st=st)
        host.set_config({
            k: {**v, "grouping_backend": "host"} if "grouping_backend" in v
            else v for k, v in cfgs.items()
        })
        dev = _ctx(tmp_path, "ev_dev", st=st, mesh=mesh)
        dev.set_config(cfgs)
        return host, dev

    def test_columnar_events_device_on_mesh(self, tmp_path):
        host, dev = self._pair(tmp_path, None)
        for name in ("events", "event_hits"):
            _table_equal(host.get_data("r", name), dev.get_data("r", name),
                         msg=f"mesh_columnar.{name}")

    def test_device_pair_events_on_mesh(self, tmp_path):
        host, dev = self._pair(tmp_path, None)
        a = host.get_data("r", "df_paired")
        b = dev.get_data("r", "df_paired")
        assert len(a) == len(b) > 0
        assert list(a.columns) == list(b.columns)
        for c in a.columns:
            av, bv = a[c].to_numpy(), b[c].to_numpy()
            if av.dtype.kind == "f":
                np.testing.assert_array_equal(
                    np.isnan(av), np.isnan(bv),
                    err_msg=f"mesh_pair.{c} NaN mask")
                np.testing.assert_array_equal(
                    av[~np.isnan(av)], bv[~np.isnan(bv)],
                    err_msg=f"mesh_pair.{c}")
            else:
                np.testing.assert_array_equal(av, bv,
                                               err_msg=f"mesh_pair.{c}")
        # fewer hits than channels somewhere -> NaN fill must survive the
        # device gather (n_channels default 2; single-hit events exist in
        # the fake run's tails)
        n_ch_cols = [c for c in a.columns if c.startswith("area_ch")]
        assert n_ch_cols, "no per-channel columns emitted"

    def test_device_pair_events_empty_window_on_mesh(self, tmp_path):
        """A window no event span fits: clean empty frame, no device error."""
        host, dev = self._pair(
            tmp_path, None,
            extra={"df_paired": {"time_window_ns": -1.0}},
        )
        b = dev.get_data("r", "df_paired")
        assert len(b) == 0
        assert list(b.columns) == list(host.get_data("r", "df_paired").columns)
