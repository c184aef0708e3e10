"""Event layer tests: df, df_events, hit_grouped, df_paired, profiles."""

import numpy as np
import pandas as pd
import pytest

from waveformanalysis_tpu.ops import grouping as G
from waveformanalysis_tpu.plugins.plugin_sets import get_profile, default_plugins
from waveformanalysis_tpu.plugins.builtin.basic_features import BasicFeaturesPlugin
from waveformanalysis_tpu.plugins.builtin.dataframe import DataFramePlugin
from waveformanalysis_tpu.plugins.builtin.event_analysis import (
    GroupedEventsPlugin,
    HitGroupedPlugin,
    PairedEventsPlugin,
)
from waveformanalysis_tpu.plugins.builtin.hit_finder import ThresholdHitPlugin
from waveformanalysis_tpu.plugins.builtin.hit_merge import (
    HitMergeClustersPlugin,
    HitMergedComponentsPlugin,
    HitMergePlugin,
)
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms, make_tiny_context


class TestGroupingOps:
    def test_anchor_window_boundaries(self):
        ts = np.array([0, 10, 20, 500, 510, 2000], dtype=np.int64)
        b = G.anchor_window_boundaries(ts, window_ps=100)
        np.testing.assert_array_equal(b, [0, 3, 5, 6])

    def test_group_multi_channel_hits(self):
        # two coincident hits on ch 1/0 + one lone hit
        df = pd.DataFrame({
            "timestamp": [100_000, 100_050_000, 100_020_000, 900_000_000],
            "channel": [1, 9, 0, 2],
            "area": [10.0, 99.0, 20.0, 30.0],
            "height": [1.0, 9.9, 2.0, 3.0],
        })
        out = G.group_multi_channel_hits(df, time_window_ns=200_000)
        assert len(out) == 2
        ev0 = out.iloc[0]
        assert ev0["n_hits"] == 3
        # channel-sorted within the event
        np.testing.assert_array_equal(ev0["channels"], [0, 1, 9])
        np.testing.assert_array_equal(ev0["areas"], [20.0, 10.0, 99.0])
        assert ev0["t_min"] == 100_000 and ev0["t_max"] == 100_050_000
        assert out.iloc[1]["n_hits"] == 1

    def test_anchor_semantics_not_chained(self):
        # hits at 0, 90, 180 with window 100: anchor rule puts 0+90 together,
        # 180 opens a new event (unlike chained-gap clustering)
        df = pd.DataFrame({
            "timestamp": [0, 90_000, 180_000],
            "channel": [0, 1, 0],
            "area": [1.0, 2.0, 3.0],
            "height": [1.0, 2.0, 3.0],
        })
        out = G.group_multi_channel_hits(df, time_window_ns=100)
        assert len(out) == 2
        assert out.iloc[0]["n_hits"] == 2

    def test_chained_gap_cluster_ids(self):
        starts = np.array([0.0, 50.0, 300.0])
        ends = np.array([40.0, 90.0, 340.0])
        ids = G.chained_gap_cluster_ids(starts, ends, gap_ps=20.0)
        np.testing.assert_array_equal(ids, [0, 0, 1])

    def test_group_hit_windows(self):
        hits = {
            "timestamp": np.array([20_000, 60_000, 9_000_000], np.int64),
            "position": np.array([10.0, 30.0, 10.0]),
            "board": np.zeros(3, np.int16),
            "channel": np.array([0, 1, 0], np.int16),
            "height": np.array([5.0, 6.0, 7.0], np.float32),
            "integral": np.array([50.0, 60.0, 70.0], np.float32),
            "record_id": np.arange(3, dtype=np.int64),
            "dt": np.array([2, 2, 2], np.int32),
            "sample_start": np.array([8, 28, 8], np.int32),
            "sample_end": np.array([12, 32, 12], np.int32),
        }
        out = G.group_hit_windows(hits, time_window_ns=50)
        assert len(out) == 2
        assert out.iloc[0]["n_hits"] == 2
        np.testing.assert_array_equal(out.iloc[0]["channels"], [0, 1])

    def test_device_backend_matches_host(self):
        # plugin-scale parity: host oracle vs jitted device kernels on the
        # same table, forced through both backends explicitly
        rng = np.random.default_rng(7)
        n = 5000
        ts = np.sort(10**15 + np.cumsum(rng.integers(0, 300_000, n)))
        df = pd.DataFrame({
            "timestamp": ts,
            "channel": rng.integers(0, 4, n).astype(np.int16),
            "area": rng.uniform(0, 100, n),
            "height": rng.uniform(0, 10, n),
        })
        host = G.group_multi_channel_hits(df, time_window_ns=250, backend="host")
        dev = G.group_multi_channel_hits(df, time_window_ns=250, backend="device")
        assert len(host) == len(dev)
        np.testing.assert_array_equal(host["t_min"], dev["t_min"])
        np.testing.assert_array_equal(host["t_max"], dev["t_max"])
        np.testing.assert_array_equal(host["n_hits"], dev["n_hits"])
        for i in (0, len(host) // 2, len(host) - 1):
            np.testing.assert_array_equal(
                host.iloc[i]["channels"], dev.iloc[i]["channels"]
            )
            np.testing.assert_array_equal(
                host.iloc[i]["areas"], dev.iloc[i]["areas"]
            )

    def test_device_backend_matches_host_hit_windows(self):
        rng = np.random.default_rng(11)
        n = 2000
        ts = np.sort(10**15 + np.cumsum(rng.integers(0, 500_000, n)))
        hits = {
            "timestamp": ts.astype(np.int64),
            "position": rng.uniform(5, 20, n),
            "board": np.zeros(n, np.int16),
            "channel": rng.integers(0, 4, n).astype(np.int16),
            "height": rng.uniform(1, 10, n).astype(np.float32),
            "integral": rng.uniform(10, 100, n).astype(np.float32),
            "record_id": np.arange(n, dtype=np.int64),
            "dt": np.full(n, 2, np.int32),
            "sample_start": rng.integers(0, 10, n).astype(np.int32),
            "sample_end": rng.integers(20, 40, n).astype(np.int32),
        }
        host = G.group_hit_windows(hits, time_window_ns=300, backend="host")
        dev = G.group_hit_windows(hits, time_window_ns=300, backend="device")
        assert len(host) == len(dev)
        np.testing.assert_array_equal(host["t_min"], dev["t_min"])
        np.testing.assert_array_equal(host["n_hits"], dev["n_hits"])

    def test_device_event_ids_random_parity(self):
        from waveformanalysis_tpu.ops import grouping_device as GD

        rng = np.random.default_rng(3)
        for _ in range(10):
            n = int(rng.integers(1, 1500))
            ts = np.sort(
                int(rng.integers(10**14, 10**15))
                + np.cumsum(rng.integers(0, 200_000, n))
            ).astype(np.int64)
            w = float(rng.uniform(0, 400_000))
            hb = G.anchor_window_boundaries(ts, w)
            eid = np.asarray(GD.anchor_window_event_ids(ts, w))
            np.testing.assert_array_equal(
                hb, GD.boundaries_from_event_ids(eid)
            )
            # event ids are the dense cluster ordinals of those boundaries
            assert eid[0] == 0
            assert np.all(np.diff(eid) >= 0)

    def test_group_events_device_aggregates(self):
        from waveformanalysis_tpu.ops import grouping_device as GD

        rng = np.random.default_rng(5)
        n = 3000
        ts = np.sort(10**15 + np.cumsum(rng.integers(0, 150_000, n)))
        areas = rng.uniform(0, 50, n)
        heights = rng.uniform(0, 5, n)
        out = GD.group_events_device(
            ts, np.zeros(n, np.int16), areas, heights, time_window_ns=200.0
        )
        b = G.anchor_window_boundaries(ts.astype(np.int64), 200.0 * 1e3)
        assert out["n_events"] == len(b) - 1
        np.testing.assert_array_equal(
            out["t_min"], np.minimum.reduceat(ts, b[:-1])
        )
        np.testing.assert_array_equal(
            out["n_hits"], np.diff(b).astype(np.int32)
        )
        np.testing.assert_allclose(
            out["area_sum"], np.add.reduceat(areas, b[:-1]), rtol=1e-12
        )

    def test_pair_events(self):
        df_events = pd.DataFrame({
            "event_id": [0, 1],
            "dt/ns": [50.0, 500.0],
            "timestamps": [np.array([0, 50_000]), np.array([0, 500_000])],
            "areas": [np.array([1.0, 2.0]), np.array([3.0])],
            "heights": [np.array([0.1, 0.2]), np.array([0.3])],
            "channels": [np.array([0, 1]), np.array([0])],
            "n_hits": [2, 1],
            "t_min": [0, 0],
            "t_max": [50_000, 500_000],
        })
        out = G.pair_events(df_events, time_window_ns=100, n_channels=2)
        assert len(out) == 1
        assert out.iloc[0]["area_ch0"] == 1.0
        assert out.iloc[0]["area_ch1"] == 2.0
        assert out.iloc[0]["delta_t"] == 50.0

    def test_pair_events_device_matches_host(self):
        """Device pairing kernel parity (ops/grouping_device.
        pair_events_device) vs the host oracle, including NaN fill for
        events shorter than the channel index and empty-cell tolerance."""
        rng = np.random.default_rng(7)
        n_events = 64
        cells_ts, cells_a, cells_h, spans = [], [], [], []
        t = 0
        for i in range(n_events):
            k = int(rng.integers(0, 4))  # 0..3 hits (0 exercises NaN fill)
            ts = np.sort(rng.integers(t, t + 400_000, k)).astype(np.int64)
            cells_ts.append(ts)
            cells_a.append(rng.normal(5, 1, k))
            cells_h.append(rng.normal(0.5, 0.1, k))
            spans.append(float(rng.uniform(0, 200)))
            t += 1_000_000
        df_events = pd.DataFrame({
            "event_id": np.arange(n_events),
            "dt/ns": spans,
            "timestamps": cells_ts,
            "areas": cells_a,
            "heights": cells_h,
            "n_hits": [len(c) for c in cells_ts],
        })
        host = G.pair_events(df_events, time_window_ns=100, n_channels=3,
                             start_channel=1, backend="host")
        dev = G.pair_events(df_events, time_window_ns=100, n_channels=3,
                            start_channel=1, backend="device")
        assert list(host.columns) == list(dev.columns)
        assert len(host) == len(dev) > 0
        for col in host.columns:
            if host[col].dtype == object:
                continue
            np.testing.assert_array_equal(
                host[col].to_numpy(), dev[col].to_numpy(), err_msg=col
            )

    def test_pair_events_device_empty_and_plugin_backend(self, tmp_path):
        # empty input stays empty through the device path
        empty = pd.DataFrame({
            "event_id": [], "dt/ns": [], "timestamps": [],
            "areas": [], "heights": [], "n_hits": [],
        })
        out = G.pair_events(empty, time_window_ns=100, n_channels=2,
                            backend="device")
        assert len(out) == 0


@pytest.fixture
def event_ctx(tmp_path):
    # coincident positive pulses on 2 channels per time slot
    st = make_fake_st_waveforms(n_events=12, wave_length=64, n_channels=2,
                                pulse_start=30, pulse_width=6,
                                pulse_height=150, polarity="positive")
    # pair events in time: events 2k and 2k+1 share a timestamp
    ts = np.repeat(np.arange(6), 2) * 1_000_000_000  # 1 ms apart (ps)
    st["timestamp"] = ts + np.tile([0, 20_000], 6)  # 20 ns offset
    wave = st["wave"].astype(np.int32)
    st["wave"] = np.clip(wave + 2 * st["channel"][:, None], -32768, 32767).astype(np.int16)
    ctx = make_tiny_context(tmp_path, st_waveforms=st)
    # pin the paired-column prefix to 0 (default is the reference's 6;
    # tests below assert area_ch0/area_ch1 names)
    ctx.set_config({"n_channels": 2, "show_progress": False,
                    "start_channel_slice": 0,
                    "basic_features": {"height_range": (0, None)}})
    ctx.register(
        BasicFeaturesPlugin(), DataFramePlugin(), GroupedEventsPlugin(),
        PairedEventsPlugin(), ThresholdHitPlugin(), HitMergePlugin(),
        HitMergeClustersPlugin(), HitMergedComponentsPlugin(), HitGroupedPlugin(),
    )
    return ctx


class TestEventPlugins:
    def test_df(self, event_ctx):
        df = event_ctx.get_data("test_run", "df")
        assert len(df) == 12
        assert {"timestamp", "channel", "area", "height"}.issubset(df.columns)
        assert "area_pe" not in df.columns

    def test_df_gain_calibration(self, event_ctx):
        event_ctx.set_config({"df": {"gain_adc_per_pe": {"0:0": 10.0, "0:1": 20.0}}})
        df = event_ctx.get_data("test_run", "df")
        assert "area_pe" in df.columns
        ch0 = df[df["channel"] == 0]
        np.testing.assert_allclose(ch0["area_pe"], ch0["area"] / 10.0)

    def test_df_events_pairs_channels(self, event_ctx):
        ev = event_ctx.get_data("test_run", "df_events")
        assert len(ev) == 6  # 6 coincident pairs
        assert (ev["n_hits"] == 2).all()
        np.testing.assert_array_equal(ev.iloc[0]["channels"], [0, 1])

    def test_df_paired(self, event_ctx):
        paired = event_ctx.get_data("test_run", "df_paired")
        assert len(paired) == 6  # 20ns offset within 100ns window
        assert {"area_ch0", "area_ch1", "height_ch0", "height_ch1",
                "delta_t"}.issubset(paired.columns)
        np.testing.assert_allclose(paired["delta_t"], 20.0)

    def test_df_paired_window_filter(self, event_ctx):
        event_ctx.set_config({"df_paired": {"time_window_ns": 10.0}})
        paired = event_ctx.get_data("test_run", "df_paired")
        assert len(paired) == 0  # 20ns offset exceeds 10ns window

    def test_hit_grouped(self, event_ctx):
        event_ctx.set_config({"hit_threshold": {"threshold": 50.0}})
        grouped = event_ctx.get_data("test_run", "hit_grouped")
        assert len(grouped) == 6
        assert (grouped["n_hits"] == 2).all()

    def test_dataframe_cache_roundtrip(self, event_ctx, tmp_path):
        df1 = event_ctx.get_data("test_run", "df_events")
        event_ctx.flush_saves()  # direct storage inspection below
        # new context, same storage -> parquet/pickle reload
        ctx2 = make_tiny_context(tmp_path, st_waveforms=make_fake_st_waveforms(1, 16))
        ctx2.register(BasicFeaturesPlugin(), DataFramePlugin(), GroupedEventsPlugin())
        key = event_ctx.key_for("test_run", "df_events")
        meta = event_ctx.storage.get_metadata(key, "test_run")
        assert meta is not None and meta["type"] == "dataframe"


class TestProfiles:
    def test_tpu_default_registers_whole_pipeline(self, tmp_path):
        from waveformanalysis_tpu.context.context import Context

        ctx = Context(storage_dir=str(tmp_path), config={"show_progress": False})
        ctx.register(*default_plugins())
        names = set(ctx.plugins)
        assert {
            "raw_files", "st_waveforms", "filtered_waveforms", "records",
            "wave_pool", "wave_pool_filtered", "hit", "hit_threshold",
            "hit_merged", "hit_merge_clusters", "hit_merged_components",
            "basic_features", "waveform_width", "waveform_width_integral",
            "s1_s2", "df", "df_events", "hit_grouped", "df_paired",
        }.issubset(names)

    def test_profile_lookup(self):
        assert len(get_profile("default")) == len(get_profile("cpu"))
        with pytest.raises(KeyError):
            get_profile("bogus")


class TestColumnarEvents:
    """Columnar events representation (events table + flat hits + offsets):
    the device-friendly alternative to df_events' object cells
    (ops/grouping.group_events_columnar + the events/event_hits plugins)."""

    def _df(self, n=200, seed=3):
        rng = np.random.default_rng(seed)
        ts = np.sort(rng.integers(0, 10**9, n)).astype(np.int64)
        return pd.DataFrame({
            "timestamp": ts,
            "channel": rng.integers(0, 3, n).astype(np.int16),
            "area": rng.normal(100, 10, n),
            "height": rng.normal(10, 1, n),
        })

    def test_columnar_matches_df_events_cells(self):
        df = self._df()
        ev_df = G.group_multi_channel_hits(df, time_window_ns=250)
        cols = G.group_events_columnar(df, time_window_ns=250)
        assert len(ev_df) == len(cols["event_id"])
        np.testing.assert_array_equal(ev_df["t_min"], cols["t_min"])
        np.testing.assert_array_equal(ev_df["t_max"], cols["t_max"])
        np.testing.assert_array_equal(ev_df["n_hits"], cols["n_hits"])
        np.testing.assert_array_equal(ev_df["dt/ns"], cols["dt_ns"])
        # flat hits slice back into exactly the df_events cells
        off = cols["hit_offset"]
        for i in range(len(ev_df)):
            lo, hi = int(off[i]), int(off[i]) + int(cols["n_hits"][i])
            np.testing.assert_array_equal(
                cols["hit_channel"][lo:hi], ev_df["channels"].iloc[i])
            np.testing.assert_array_equal(
                cols["hit_area"][lo:hi], ev_df["areas"].iloc[i])
            np.testing.assert_array_equal(
                cols["hit_timestamp"][lo:hi], ev_df["timestamps"].iloc[i])
            np.testing.assert_array_equal(
                cols["hit_event_id"][lo:hi], np.full(hi - lo, i))

    def test_columnar_device_backend_matches_host(self):
        df = self._df(seed=9)
        host = G.group_events_columnar(df, time_window_ns=250, backend="host")
        dev = G.group_events_columnar(df, time_window_ns=250, backend="device")
        for k in host:
            np.testing.assert_array_equal(host[k], dev[k], err_msg=k)

    def test_columnar_empty(self):
        empty = pd.DataFrame({"timestamp": [], "channel": [], "area": [],
                              "height": []})
        cols = G.group_events_columnar(empty, time_window_ns=100)
        assert len(cols["event_id"]) == 0 and len(cols["hit_area"]) == 0

    def test_pair_events_columnar_matches_pandas_path(self):
        df = self._df(seed=5)
        ev_df = G.group_multi_channel_hits(df, time_window_ns=250)
        cols = G.group_events_columnar(df, time_window_ns=250)
        ref = G.pair_events(ev_df, time_window_ns=400, n_channels=3)
        for backend in ("host", "device"):
            got = G.pair_events_columnar(
                cols, cols, time_window_ns=400, n_channels=3,
                backend=backend,
            )
            assert len(got) == len(ref), backend
            for col in ("event_id", "t_min", "t_max", "dt/ns", "n_hits",
                        "delta_t", "area_ch0", "area_ch1", "area_ch2",
                        "height_ch0", "height_ch1", "height_ch2"):
                np.testing.assert_array_equal(
                    np.asarray(ref[col]), np.asarray(got[col]),
                    err_msg=f"{backend}:{col}",
                )

    def test_plugins_through_context(self, event_ctx):
        from waveformanalysis_tpu.plugins.builtin.event_analysis import (
            EventHitsPlugin,
            EventsPlugin,
        )

        event_ctx.register(EventsPlugin(), EventHitsPlugin())
        ev = event_ctx.get_data("test_run", "events")
        hits = event_ctx.get_data("test_run", "event_hits")
        ev_df = event_ctx.get_data("test_run", "df_events")
        assert len(ev) == len(ev_df) == 6
        np.testing.assert_array_equal(np.asarray(ev["t_min"]),
                                      ev_df["t_min"].to_numpy())
        assert len(hits) == int(np.asarray(ev["n_hits"]).sum()) == 12

    def test_df_paired_columnar_source(self, event_ctx):
        from waveformanalysis_tpu.plugins.builtin.event_analysis import (
            EventHitsPlugin,
            EventsPlugin,
        )

        event_ctx.register(EventsPlugin(), EventHitsPlugin())
        ref = event_ctx.get_data("test_run", "df_paired")

        ctx2 = event_ctx.clone()
        ctx2.set_config({"df_paired": {"events_source": "columnar"}})
        got = ctx2.get_data("test_run", "df_paired")
        assert len(got) == len(ref) > 0
        for col in ("event_id", "t_min", "t_max", "n_hits", "delta_t",
                    "area_ch0", "area_ch1", "height_ch0", "height_ch1"):
            np.testing.assert_array_equal(
                np.asarray(ref[col]), np.asarray(got[col]), err_msg=col
            )
        # lineage differs: events_source is a tracked option
        assert ctx2.key_for("test_run", "df_paired") != \
            event_ctx.key_for("test_run", "df_paired")


def test_reference_profile_names_all_work():
    """Every profile name the reference declares (including its
    NotImplementedError placeholders streaming/jax — profiles.py:33-41)
    returns a working plugin list here."""
    from waveformanalysis_tpu.plugins.plugin_sets import get_profile

    base = {p.provides for p in get_profile("cpu_default")}
    for name in ("cpu", "cpu_default", "jax", "jax_accel", "default"):
        assert {p.provides for p in get_profile(name)} == base, name
    streaming = {p.provides for p in get_profile("streaming")}
    assert streaming == base | {"signal_peaks_stream"}
    assert {p.provides for p in get_profile("streaming_default")} == streaming
