"""Per-plugin Context integration matrix: every provided data name on a
synthetic DAQ run (reference analog: tests/plugins/test_plugin_auto_config_*).

For each data name the full default_plugins profile provides, this drives a
REAL Context over a synthetic VX2730 run on disk: compute -> contract check
-> memory-cache hit -> cloned-context disk reload equality. A second class
runs the auto-config matrix: one option change per plugin must change its
cache key and invalidate, an untracked option must not.
"""

from pathlib import Path

import numpy as np
import pytest

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from utils import create_daq_run

RUN = "run_001"

# every data name the default profile provides, with its result contract
EXPECTED_KINDS = {
    "raw_files": "list",
    "st_waveforms": "table",
    "records": "table",
    "wave_pool": "array",
    "wave_pool_filtered": "array",
    "filtered_waveforms": "table",
    "hit": "table",
    "hit_threshold": "table",
    "hit_merge_clusters": "table",
    "hit_merged": "table",
    "hit_merged_components": "table",
    "basic_features": "table",
    "waveform_width": "table",
    "waveform_width_integral": "table",
    "s1_s2": "table",
    "events": "table",
    "event_hits": "table",
    "df": "dataframe",
    "df_events": "dataframe",
    "df_paired": "dataframe",
    "hit_grouped": "dataframe",
}

# data names whose output may legitimately be empty on this synthetic run
MAY_BE_EMPTY = set()


@pytest.fixture(scope="module")
def daq_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("daq")
    # POSITIVE-going pulses (pulse_height<0 flips the fixture's subtraction)
    # so waveform_width's positive-going convention yields rows; two files
    # per channel exercises the header-rows-on-first-file-only contract
    create_daq_run(root, RUN, n_channels=2, n_files_per_channel=2,
                   n_rows=24, n_samples=64, pulse_height=-300)
    return root


def _make_ctx(storage_dir, daq_root) -> Context:
    ctx = Context(
        storage_dir=str(storage_dir),
        config={
            "show_progress": False,
            "data_root": str(daq_root),
            "daq_adapter": "vx2730",
            "n_channels": 2,
            "channel_metadata": {
                "0:0": {"polarity": "positive"},
                "0:1": {"polarity": "positive"},
            },
        },
    )
    ctx.register(*default_plugins())
    # the synthetic square pulse is negative-going; detect on the inverted
    # signal with thresholds matched to the 300-ADC pulse
    ctx.set_config({
        "hit": {"use_derivative": False, "height": 100.0,
                "prominence": 50.0, "width": 2, "use_filtered": False},
        "hit_threshold": {"threshold": 100.0},
        "s1_s2": {"s1_width_range": (0.0, 30.0),
                  "s2_width_range": (40.0, 100000.0)},
    })
    return ctx


@pytest.fixture(scope="module")
def ctx(tmp_path_factory, daq_root):
    return _make_ctx(tmp_path_factory.mktemp("storage"), daq_root)


def _profile_provides():
    return [p.provides for p in default_plugins()]


def test_expected_kinds_cover_profile():
    provides = set(_profile_provides())
    missing = provides - set(EXPECTED_KINDS)
    assert not missing, f"EXPECTED_KINDS missing entries for: {missing}"


@pytest.mark.parametrize("name", sorted(EXPECTED_KINDS))
class TestEveryDataName:
    def test_compute_contract_and_cache(self, ctx, name):
        out = ctx.get_data(RUN, name)
        kind = EXPECTED_KINDS[name]
        if kind == "table":
            assert isinstance(out, (Table, np.ndarray)), type(out)
            if name not in MAY_BE_EMPTY:
                assert len(out) > 0, f"{name} produced no rows"
        elif kind == "dataframe":
            assert hasattr(out, "columns") and hasattr(out, "iloc")
            if name not in MAY_BE_EMPTY:
                assert len(out) > 0
        elif kind == "array":
            assert isinstance(out, np.ndarray)
            assert out.size > 0
        elif kind == "list":
            assert isinstance(out, (list, tuple)) and len(out) > 0
        # second read: memory cache returns an equivalent object
        again = ctx.get_data(RUN, name)
        assert type(again) is type(out) or isinstance(again, type(out))

    def test_disk_reload_parity(self, ctx, name):
        plugin = ctx.get_plugin(name)
        if plugin is not None and plugin.save_when == "never":
            pytest.skip("save_when=never is not persisted")
        first = ctx.get_data(RUN, name)
        clone = ctx.clone()
        reloaded = clone.get_data(RUN, name)
        summary = str(clone.profiler.summary())
        assert f"plugin.{name}.compute" not in summary, \
            f"{name} recomputed instead of loading from cache"
        if isinstance(first, Table):
            reloaded_t = reloaded if isinstance(reloaded, Table) \
                else Table.from_numpy(reloaded)
            for f in first.field_names:
                np.testing.assert_array_equal(
                    np.asarray(first[f]), np.asarray(reloaded_t[f]),
                    err_msg=f"{name}.{f}",
                )
        elif isinstance(first, np.ndarray):
            np.testing.assert_array_equal(np.asarray(first),
                                          np.asarray(reloaded))
        elif hasattr(first, "columns") and hasattr(first, "iloc"):
            assert len(first) == len(reloaded)


class TestAutoConfigMatrix:
    """One tracked-option change per plugin must change the cache key;
    untracked options must not (reference: test_plugin_auto_config_*)."""

    TRACKED_CHANGES = {
        "st_waveforms": {"baseline_samples": 10},
        "filtered_waveforms": {"filter_type": "BW"},
        "hit": {"height": 77.0},
        "hit_threshold": {"threshold": 33.0},
        "hit_merged": {"merge_gap_ns": 123.0},  # applied at the OWNER scope

        "basic_features": {"height_range": (10, 60)},
        "waveform_width": {"rise_low": 0.2},
        "waveform_width_integral": {"q_low": 0.2},
        "s1_s2": {"s1_width_range": (0.0, 20.0)},
        "df_events": {"time_window_ns": 777.0},
        "df_paired": {"time_window_ns": 555.0},
    }

    # the hit-merge family resolves gap/width under the hit_merge_clusters
    # scope (reference owner-scope semantics; docs/PARITY.md) — config
    # changes that should rotate hit_merged's key must target that scope
    TRACKED_SCOPE = {"hit_merged": "hit_merge_clusters"}

    UNTRACKED_CHANGES = {
        "hit": {"peaks_backend": "xla"},
        "hit_threshold": {"max_hits_per_waveform": 32},
        "df_events": {"grouping_backend": "host"},
        # self-scoped gap is INERT for the merge family (owner-scope
        # semantics) and therefore must not rotate the key either
        "hit_merged": {"merge_gap_ns": 321.0},
    }

    @pytest.mark.parametrize("name", sorted(TRACKED_CHANGES))
    def test_tracked_option_changes_key(self, tmp_path, daq_root, name):
        ctx = _make_ctx(tmp_path, daq_root)
        key_before = ctx.key_for(RUN, name)
        scope = self.TRACKED_SCOPE.get(name, name)
        ctx.set_config({scope: self.TRACKED_CHANGES[name]})
        key_after = ctx.key_for(RUN, name)
        assert key_before != key_after, \
            f"tracked option change did not rotate {name} key"

    @pytest.mark.parametrize("name", sorted(UNTRACKED_CHANGES))
    def test_untracked_option_keeps_key(self, tmp_path, daq_root, name):
        ctx = _make_ctx(tmp_path, daq_root)
        key_before = ctx.key_for(RUN, name)
        ctx.set_config({name: self.UNTRACKED_CHANGES[name]})
        key_after = ctx.key_for(RUN, name)
        assert key_before == key_after, \
            f"untracked option rotated {name} key"

    def test_upstream_change_invalidates_downstream(self, tmp_path, daq_root):
        # wave_source=auto resolves to st_waveforms (reference semantics):
        # st_waveforms feeds basic_features -> df -> df_events -> df_paired
        # and filtered_waveforms; a records config change only reaches the
        # feature chain when wave_source="records" is requested explicitly
        ctx = _make_ctx(tmp_path, daq_root)
        st_downstream = ["basic_features", "df", "df_events", "df_paired",
                         "filtered_waveforms"]
        before = {n: ctx.key_for(RUN, n) for n in st_downstream}
        ctx.set_config({"st_waveforms": {"baseline_samples": 11}})
        for n in st_downstream:
            assert ctx.key_for(RUN, n) != before[n], \
                f"st_waveforms change did not propagate into {n} lineage"
        ctx.set_config({"basic_features": {"wave_source": "records"}})
        rec_key = ctx.key_for(RUN, "basic_features")
        ctx.set_config({"records": {"baseline_samples": 11}})
        assert ctx.key_for(RUN, "basic_features") != rec_key, \
            "records change did not propagate under wave_source=records"


class TestV1725PluginMatrix:
    """The binary adapter family through the same Context plumbing."""

    @pytest.fixture()
    def v_ctx(self, tmp_path):
        from utils import write_v1725_run

        write_v1725_run(tmp_path / "daq", "rb", n_events=6, n_samples=32)
        ctx = Context(
            storage_dir=str(tmp_path / "st"),
            config={"show_progress": False,
                    "data_root": str(tmp_path / "daq"),
                    "daq_adapter": "v1725"},
        )
        ctx.register(*default_plugins())
        ctx.set_config({
            "raw_files": {"daq_adapter": "v1725"},
            "records": {"daq_adapter": "v1725"},
            "wave_pool": {"daq_adapter": "v1725"},
            "st_waveforms": {"daq_adapter": "v1725"},
            "basic_features": {"wave_source": "records"},
        })
        return ctx

    def test_records_and_features(self, v_ctx):
        rec = v_ctx.get_data("rb", "records")
        assert len(rec) == 12  # 6 events x 2 channels
        feats = v_ctx.get_data("rb", "basic_features")
        assert len(feats) == 12
        assert np.all(np.asarray(feats["height"]) >= 0)


class TestV1725FullChain:
    """The binary adapter through the WHOLE pipeline (not just records):
    detection, widths, classification, grouping on V1725 data."""

    @pytest.fixture()
    def v_full_ctx(self, tmp_path):
        import numpy as np

        from utils import make_v1725_event

        # build a run with real pulses: baseline 1000, negative square dips
        raw = tmp_path / "daq" / "rv" / "RAW"
        raw.mkdir(parents=True, exist_ok=True)
        blob = b""
        for i in range(12):
            w0 = np.full(64, 1000, dtype=np.int16)
            w0[20:26] -= 400
            w1 = np.full(64, 1000, dtype=np.int16)
            w1[22:40] -= 300
            blob += make_v1725_event(
                {0: w0, 1: w1},
                timestamps={0: 1000 + i * 500, 1: 1000 + i * 500},
                baselines={0: 1000, 1: 1000},
            )
        (raw / "test_raw_b0_seg0.bin").write_bytes(blob)

        ctx = Context(
            storage_dir=str(tmp_path / "st"),
            config={"show_progress": False,
                    "data_root": str(tmp_path / "daq"),
                    "daq_adapter": "v1725"},
        )
        ctx.register(*default_plugins())
        ctx.set_config({
            "raw_files": {"daq_adapter": "v1725"},
            "records": {"daq_adapter": "v1725"},
            "wave_pool": {"daq_adapter": "v1725"},
            "st_waveforms": {"daq_adapter": "v1725"},
            "basic_features": {"wave_source": "records"},
            "hit": {"wave_source": "records", "use_filtered": False,
                    "use_derivative": False, "height": 100.0,
                    "prominence": 50.0, "width": 2, "dt": 4},
            "hit_threshold": {"wave_source": "records", "threshold": 100.0,
                              "dt": 4},
            "waveform_width_integral": {"wave_source": "records"},
            "s1_s2": {"s1_width_range": (0.0, 40.0),
                      "s2_width_range": (40.0, 100000.0)},
        })
        return ctx

    def test_hits_detected_on_binary_run(self, v_full_ctx):
        hits = v_full_ctx.get_data("rv", "hit")
        assert len(hits) == 24  # one pulse per record
        thr = v_full_ctx.get_data("rv", "hit_threshold")
        assert len(thr) == 24

    def test_width_integral_and_grouping(self, v_full_ctx):
        wint = v_full_ctx.get_data("rv", "waveform_width_integral")
        assert len(wint) == 24
        w = np.asarray(wint["width_samples"])
        assert np.all(w > 0)
        # wide channel-1 pulses measurably wider than channel-0 spikes
        ch = np.asarray(wint["channel"])
        assert np.median(w[ch == 1]) > np.median(w[ch == 0])
        ev = v_full_ctx.get_data("rv", "df_events")
        assert len(ev) == 12  # per-event coincidence across both channels
        assert np.all(np.asarray(ev["n_hits"]) == 2)

    def test_fusion_covers_v1725_records_source(self, v_full_ctx):
        out = v_full_ctx.get_data(
            "rv", ["basic_features", "hit_threshold",
                   "waveform_width_integral"]
        )
        assert all(len(v) == 24 for v in out.values())
        assert "fusion.wave_chain.compute" in str(
            v_full_ctx.profiler.summary()
        )
