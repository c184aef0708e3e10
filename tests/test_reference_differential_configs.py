"""Config-sweep differential: the reference package as an oracle OFF defaults.

`test_reference_differential.py` pins field-by-field parity on the default
configuration. Off-default semantics are where a shared misreading hides —
an option we plumb to the wrong knob, a threshold compared with `>` where
the reference uses `>=`, a unit conversion applied once instead of twice.
This module drives BOTH Contexts (ours and `/root/reference`'s — reference
entry: waveform_analysis/core/context.py:832 get_data, option surfaces:
core/plugins/builtin/cpu/{peak_finding,hit_finder,hit_merge,filtering,
basic_features,waveform_width,waveform_width_integral,s1_s2_classifier,
waveforms}.py) over the SAME multi-pulse synthetic VX2730 run under a
matrix of non-default option sets, and compares the affected outputs with
the base module's field-by-field machinery.

Every sweep also asserts it is DISCRIMINATING: the swept output must differ
from the default-config output on our side. A sweep that produces identical
outputs is testing nothing (the option may be silently ignored), so that is
a failure too.

The run is multi-pulse by construction (four square pulses of varied
height/width/separation per waveform) so distance/prominence/width/merge
options actually change the result set.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_reference_differential as base  # noqa: E402

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module", autouse=True)
def _fresh_jax_caches():
    """Drop compiled programs accumulated by the rest of the suite.

    In a full-suite run this module starts after ~1300 tests' worth of
    live XLA CPU executables; twice that state has ended in a SIGSEGV
    inside XLA's backend_compile_and_load while compiling this module's
    fused programs (2026-08-19 full-suite logs). Standalone runs are
    clean, so shed the accumulated executables first — recompiling here
    costs seconds."""
    import jax

    jax.clear_caches()
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# sweep matrix: (id, config, names to compare, names that must differ from
# the default-config output on our side, {(name, field): atol} overrides)
#
# Values are CALIBRATED against the fixture below: hit detection runs on the
# SG(11,2)-filtered derivative by default (use_filtered=True,
# use_derivative=True), which smears the square-pulse edge spikes — the
# 26-ADC pulse's filtered-derivative peak is ~7, and raw 1-sample derivative
# spikes fail the default width=4 condition.
# ---------------------------------------------------------------------------
SWEEPS = [
    # peak finding (reference: cpu/peak_finding.py options)
    ("peaks_low_height",
     {"hit": {"height": 5.0, "prominence": 0.5}},
     ["hit"], ["hit"], None),
    ("peaks_distance",
     {"hit": {"distance": 20}},
     ["hit"], ["hit"], None),
    ("peaks_prominence_width",
     {"hit": {"prominence": 50.0, "width": 6}},
     ["hit"], ["hit"], None),
    ("peaks_abs_wave",
     {"hit": {"use_derivative": False, "height": 50.0}},
     ["hit"], ["hit"], None),
    ("peaks_raw_wave",
     {"hit": {"use_filtered": False, "width": 1}},
     ["hit"], ["hit"], None),
    ("peaks_height_diff_method",
     {"hit": {"height_method": "diff"}},
     ["hit"], ["hit"], None),
    # scipy neighbor-threshold condition (hit 3.2.0+; raw wave so the
    # neighbor diffs are integer-exact on both sides)
    ("peaks_threshold",
     {"hit": {"use_filtered": False, "use_derivative": False,
              "height": 50.0, "width": 1, "threshold": 30.0}},
     ["hit"], ["hit"], None),
    ("peaks_window_ext",
     {"hit": {"height_window_extension": 8}},
     ["hit"], ["hit"], None),
    # threshold hit finder (reference: cpu/hit_finder.py options)
    ("threshold_hits",
     {"hit_threshold": {"threshold": 60.0, "left_extension": 5,
                        "right_extension": 7}},
     ["hit_threshold"], ["hit_threshold"], None),
    ("threshold_on_filtered",
     {"hit_threshold": {"use_filtered": True}},
     ["hit_threshold"], ["hit_threshold"], None),
    # hit merging (reference: cpu/hit_merge.py options; the reference
    # default merge_gap_ns=0.0 DISABLES merging, so any positive gap is a
    # discriminating sweep — this matrix is what caught our r1-r4 default
    # of 50.0 silently merging out of the box). The cluster definition is
    # OWNED by the hit_merge_clusters scope: the reference's hit_merged
    # consumes that plugin's precomputed clusters (cpu/hit_merge.py:353-371),
    # so gap config must target "hit_merge_clusters" or a global key — a
    # "hit_merged"-scoped gap is inert (pinned below).
    ("merge_gap",
     {"hit_merge_clusters": {"merge_gap_ns": 80.0}},
     ["hit_threshold", "hit_merged"], ["hit_merged"], None),
    ("merge_gap_mid",
     {"hit_merge_clusters": {"merge_gap_ns": 20.0}},
     ["hit_merged"], ["hit_merged"], None),
    ("merge_capped_width",
     {"hit_merge_clusters": {"merge_gap_ns": 200.0,
                             "max_total_width_ns": 60.0}},
     ["hit_merged"], ["hit_merged"], None),
    ("merge_gap_global",
     {"merge_gap_ns": 30.0},
     ["hit_merged"], ["hit_merged"], None),
    # the inert scope: hit_merged-scoped gap must merge NOTHING on either
    # side (diff_names empty: output must EQUAL the defaults)
    ("merge_scope_inert",
     {"hit_merged": {"merge_gap_ns": 80.0}},
     ["hit_merged"], [], None),
    # wave_source=records: identical VALUES sourced through the records
    # path instead of st_waveforms — diff_names is EMPTY on purpose (the
    # r4 wave_source bug was a silent mis-JOIN with value-identical
    # inputs, so equality-with-defaults plus reference parity is exactly
    # the pin this needs; id fields are excluded by the comparator)
    ("wave_source_records",
     {"wave_source": "records"},
     ["basic_features", "hit", "hit_threshold", "s1_s2"], [], None),
    # features over the SG-filtered wave (reference: cpu/basic_features.py
    # use_filtered)
    ("features_filtered",
     {"basic_features": {"use_filtered": True}},
     ["basic_features"], ["basic_features"], None),
    # zero-phase filtering (reference: cpu/filtering.py options). The BW
    # branch is a forward-backward IIR cascade: our kernel recurses in f32
    # (device) vs the reference's scipy f64 sosfiltfilt, so the wave
    # field gets an absolute tolerance (max observed ~2.3e-4 on +/-320 ADC
    # waves; docs/PARITY.md).
    ("filter_bw",
     {"filtered_waveforms": {"filter_type": "BW", "lowcut": 0.02,
                             "highcut": 0.15, "filter_order": 3}},
     ["filtered_waveforms"], ["filtered_waveforms"],
     {("filtered_waveforms", "wave"): 5e-4}),
    ("filter_sg",
     {"filtered_waveforms": {"sg_window_size": 15, "sg_poly_order": 3}},
     ["filtered_waveforms"], ["filtered_waveforms"], None),
    # BW with a non-default sampling rate: fs renormalizes the cutoffs, a
    # classic unit-convention divergence spot (GHz convention, fs=0.5)
    ("filter_bw_fs",
     {"filtered_waveforms": {"filter_type": "BW", "lowcut": 0.02,
                             "highcut": 0.1, "fs": 0.25}},
     ["filtered_waveforms"], ["filtered_waveforms"],
     {("filtered_waveforms", "wave"): 5e-4}),
    # waveform width levels (reference: cpu/waveform_width.py options)
    ("width_levels",
     {"waveform_width": {"rise_low": 0.2, "rise_high": 0.8,
                         "fall_high": 0.75, "fall_low": 0.25}},
     ["waveform_width"], ["waveform_width"], None),
    ("width_no_interp",
     {"waveform_width": {"interpolation": False}},
     ["waveform_width"], ["waveform_width"], None),
    ("width_filtered",
     {"waveform_width": {"use_filtered": True}},
     ["waveform_width"], ["waveform_width"], None),
    # integral width quantiles (reference: cpu/waveform_width_integral.py)
    ("wwi_quantiles",
     {"waveform_width_integral": {"q_low": 0.25, "q_high": 0.75}},
     ["waveform_width_integral"], ["waveform_width_integral"], None),
    # sampling_rate drives the samples->ns conversion of t_low/t_high/width
    # — but ONLY when dt is not resolvable: BOTH resolvers adapter-infer dt
    # (=2 ns on vx2730; reference resolver.py:62), and dt outranks
    # sampling_rate (reference waveform_width_integral.py:79). Two pins:
    # explicit dt=None activates sampling_rate (discriminating), and
    # sampling_rate alone is INERT (equal to defaults) on both sides.
    ("wwi_sampling_rate",
     {"waveform_width_integral": {"dt": None, "sampling_rate": 0.25}},
     ["waveform_width_integral"], ["waveform_width_integral"], None),
    ("wwi_sampling_rate_inert",
     {"waveform_width_integral": {"sampling_rate": 0.25}},
     ["waveform_width_integral"], [], None),
    # feature windows (reference: cpu/basic_features.py options —
    # height_range/area_range are SAMPLE WINDOWS, not value gates)
    ("features_windows",
     {"basic_features": {"height_range": (44, 120), "area_range": (40, 140)}},
     ["basic_features"], ["basic_features"], None),
    # layered per-channel fixed baseline (reference: core/hardware/channel.py
    # defaults + per-channel override resolution)
    ("features_channel_baseline",
     {"basic_features": {"channel_config": {
         "defaults": {"fixed_baseline": 996.0},
         "0:1": {"fixed_baseline": 1004.0},
     }}},
     ["basic_features"], ["basic_features"], None),
    # S1/S2 classification actually classifying (reference:
    # cpu/s1_s2_classifier.py options; defaults leave every range None)
    ("s1s2_ranges",
     {"s1_s2": {"s1_width_range": (0.0, 30.0),
                "s2_width_range": (30.0, 10000.0),
                "conflict_policy": "prefer_s1"}},
     ["s1_s2"], ["s1_s2"], None),
    ("s1s2_samples_unit",
     {"s1_s2": {"width_unit": "samples",
                "s1_width_range": (0.0, 15.0),
                "s2_width_range": (15.0, 5000.0)}},
     ["s1_s2"], ["s1_s2"], None),
    # acquisition-side baseline window (reference: cpu/waveforms.py options)
    ("baseline_window",
     {"st_waveforms": {"baseline_samples": 16}},
     ["st_waveforms", "basic_features"], ["st_waveforms"], None),
    # --- event layer (reference: cpu/event_analysis.py + analyzer.py) ---
    # the rich run staggers channel 1 by 120 ns (channel_offset_ps), so a
    # 100-ns default window keeps channels in separate events and a 250-ns
    # window groups them — the sweeps below are discriminating on real
    # cross-channel structure, not just column cosmetics.
    ("events_window_scoped",
     {"df_events": {"time_window_ns": 250.0}},
     ["df_events", "df_paired"], ["df_events", "df_paired"], None),
    # the rich run's hit windows interleave across the staggered channels
    # with gaps of ~16-46 ns, so the default 100-ns window already chains
    # them into one event per slot — discriminate by SHRINKING the window
    ("grouped_window",
     {"hit_grouped": {"time_window_ns": 30.0}},
     ["hit_grouped"], ["hit_grouped"], None),
    # the GLOBAL key drives df_events + hit_grouped (resolver global
    # fallback) AND df_paired's pairing threshold (the reference reads it
    # RAW from context.config, event_analysis.py:141)
    # (hit_grouped rides along for parity only: 250 ns does not change its
    # grouping — see grouped_window above)
    ("global_time_window",
     {"time_window_ns": 250.0},
     ["df_events", "hit_grouped", "df_paired"],
     ["df_events", "df_paired"], None),
    # start_channel_slice only prefixes df_paired's area_ch*/height_ch*
    # column names (reference analyzer.py:27 default 6; the global key is
    # read raw on both sides) — sweeping it to 0 pins the key plumbing AND
    # that the true default diverges from it
    ("paired_channel_slice",
     {"start_channel_slice": 0},
     ["df_paired"], ["df_paired"], None),
    # per-channel gain calibration (reference: cpu/dataframe.py
    # gain_adc_per_pe -> calibrated columns)
    ("df_gain",
     {"df": {"gain_adc_per_pe": {"0:0": 10.0, "0:1": 20.0}}},
     ["df"], ["df"], None),
    # memory-bounded streaming ingest (reference cpu/waveforms.py:1457
    # _compute_streaming; ours r5 WaveformsPlugin._compute_streaming). By
    # contract the mode is INVISIBLE in the output on both sides, so the
    # discrimination list is empty by design — the sweep pins that both
    # streaming implementations still agree with each other end-to-end.
    ("streaming_mode_ingest",
     {"st_waveforms": {"streaming_mode": True}},
     ["st_waveforms", "hit"], [], None),
]


@pytest.fixture(scope="module")
def rich_run(tmp_path_factory):
    """Multi-pulse VX2730 run shared by every sweep."""
    tmp = tmp_path_factory.mktemp("diff_cfg")
    from waveformanalysis_tpu.testing.fixtures import make_synthetic_vx2730_run

    run_dir = make_synthetic_vx2730_run(
        str(tmp / "DAQ"), "run_cfg", n_channels=2, n_rows=48,
        n_samples=160, noise=4, seed=11,
        channel_offset_ps=120_000,  # 120 ns cross-channel stagger
        pulses=[
            (48, 320, 4),    # tall narrow
            (60, 90, 3),     # medium, 12 samples after the first
            (84, 26, 3),     # small (below the default height=30 gate)
            (110, 180, 14),  # tall wide
        ],
    )
    return tmp, (tmp / "DAQ", run_dir)


def _materialize_names(ctx, run_id, names):
    import pandas as pd

    out = {}
    for name in names:
        data = ctx.get_data(run_id, name)
        if hasattr(data, "to_numpy") and not isinstance(data, pd.DataFrame):
            data = data.to_numpy()
        elif isinstance(data, np.memmap):
            data = np.asarray(data)
        out[name] = data
    return out


def _drive(rich_run, sweep_id, cfg, names, side):
    tmp, (root, run_dir) = rich_run
    run_id = os.path.basename(str(run_dir))
    store = tmp / f"store_{side}_{sweep_id}"
    if side == "ref":
        base._import_reference()
        ctx = base._build_ref_context(store, root, "vx2730", cfg)
    else:
        ctx = base._build_our_context(store, root, "vx2730", cfg)
    return _materialize_names(ctx, run_id, names)


@pytest.fixture(scope="module")
def our_defaults(rich_run):
    """Our default-config outputs over the rich run, for the
    discrimination guard."""
    union = sorted({n for _, _, names, _, _ in SWEEPS for n in names})
    return _drive(rich_run, "defaults", None, union, "ours")


def _df_fingerprint(df):
    """Order-insensitive string fingerprint of a DataFrame (object cells
    rendered through numpy so NaN compares equal to NaN)."""
    cols = sorted(map(str, df.columns))
    rows = []
    for _, row in df.iterrows():
        parts = []
        for c in cols:
            v = row[c]
            if isinstance(v, (np.ndarray, list, tuple)):
                parts.append(np.array2string(np.asarray(v), precision=10))
            else:
                parts.append(repr(v))
        rows.append("|".join(parts))
    return (tuple(cols), tuple(sorted(rows)))


def _rows_differ(name, a, b):
    import pandas as pd

    if isinstance(a, pd.DataFrame):
        return _df_fingerprint(a) != _df_fingerprint(b)
    if len(a) != len(b):
        return True
    if len(a) == 0:
        return False
    keys = base.SORT_KEYS[name]
    ra, rb, _, _ = base._sorted_pair(name, a, b)
    for f in a.dtype.names:
        if f in base.ID_FIELDS:
            continue
        va, vb = ra[f], rb[f]
        if va.dtype.kind in "fc":
            na, nb = np.isnan(va), np.isnan(vb)
            if not np.array_equal(na, nb):
                return True
            if not np.array_equal(np.nan_to_num(va), np.nan_to_num(vb)):
                return True
        elif not np.array_equal(va, vb):
            return True
    del keys
    return False


# Module-wide tolerance relaxations on top of the base module's classes.
# The rich run has 160-sample waves (vs the base fixtures' 64/96) and hit
# detection runs on the f4 FILTERED wave by default, so interpolated
# crossings and filtered-wave heights inherit the filtered wave's
# rtol-1e-5-class error SCALED BY VALUE: edge positions up to ~155 carry
# ~1.5e-4 absolute, heights measured on the filtered wave a hair over the
# f4 class's rtol 1e-5. (rtol, atol) pairs; see docs/PARITY.md.
DEFAULT_ATOL_OVERRIDES = {
    ("hit", "edge_start"): (1e-5, 1e-4),
    ("hit", "edge_end"): (1e-5, 1e-4),
    ("hit_threshold", "height"): (3e-5, 1e-6),
    ("hit_threshold", "integral"): (3e-5, 1e-6),
    ("hit_threshold", "edge_start"): (1e-5, 1e-4),
    ("hit_threshold", "edge_end"): (1e-5, 1e-4),
    ("hit_threshold", "width"): (1e-5, 1e-4),
    ("hit_threshold", "rise_time"): (1e-5, 1e-4),
    ("hit_threshold", "fall_time"): (1e-5, 1e-4),
}


# per-sweep field exclusions: {sweep_id: {(data_name, field), ...}} for
# reference-side artifacts a sweep exposes (each ledgered in docs/PARITY.md)
SWEEP_EXCLUDE_FIELDS = {
    # the reference's streaming branch returns WITHOUT calling
    # _apply_polarity_metadata (cpu/waveforms.py:1252-1263 vs :1297), so its
    # streaming polarity strings stay '' instead of 'unknown'. This build
    # applies polarity metadata uniformly in both modes.
    "streaming_mode_ingest": {("st_waveforms", "polarity")},
}


@pytest.mark.parametrize(
    "sweep_id,cfg,names,diff_names,atol_overrides",
    SWEEPS, ids=[s[0] for s in SWEEPS],
)
def test_config_sweep_parity(rich_run, our_defaults, sweep_id, cfg, names,
                             diff_names, atol_overrides):
    atol_overrides = {**DEFAULT_ATOL_OVERRIDES, **(atol_overrides or {})}
    ours = _drive(rich_run, sweep_id, cfg, names, "ours")

    # the sweep must actually change something, else it tests nothing
    for name in diff_names:
        assert _rows_differ(name, our_defaults[name], ours[name]), (
            f"sweep '{sweep_id}' did not change '{name}' vs defaults — "
            "option may be silently ignored"
        )

    ref = _drive(rich_run, sweep_id, cfg, names, "ref")
    injected = []
    for data_name, field in SWEEP_EXCLUDE_FIELDS.get(sweep_id, ()):
        key = ("vx2730", data_name)
        base.EXCLUDE_FIELDS.setdefault(key, set())
        if field not in base.EXCLUDE_FIELDS[key]:
            base.EXCLUDE_FIELDS[key].add(field)
            injected.append((key, field))
    try:
        for name in names:
            _compare_any(name, ref[name], ours[name], atol_overrides)
    finally:
        for key, field in injected:
            base.EXCLUDE_FIELDS[key].discard(field)


# ---------------------------------------------------------------------------
# V1725 (binary adapter) sweeps: the config machinery is adapter-agnostic,
# but the acquisition options flow through a completely different decode
# path (binary headers, device unpack) — pin that off-default acquisition
# semantics survive it. The reference context needs the same instance
# output_dtype pin as the base module's v1725_pair (its V1725 compute
# branch returns before the dtype reassignment; docs/PARITY.md).
# ---------------------------------------------------------------------------
V1725_SWEEPS = [
    # dt override propagates from st_waveforms into hit dt and ns widths
    ("v_dt_override",
     {"st_waveforms": {"dt": 7}},
     ["st_waveforms", "hit_threshold"], ["st_waveforms"], None),
    ("v_threshold",
     {"hit_threshold": {"threshold": 200.0, "left_extension": 2,
                        "right_extension": 2}},
     ["hit_threshold"], ["hit_threshold"], None),
    ("v_peaks_raw",
     {"hit": {"height": 40.0, "use_filtered": False, "width": 1}},
     ["hit"], ["hit"], None),
    # consecutive same-channel hits sit ~2000 ns apart (one pulse per
    # event), so a 2500-ns gap chains them until the default 1e4-ns
    # max_total_width cap splits the chain — gap AND cap parity on the
    # binary path in one sweep
    ("v_merge_gap",
     {"hit_merge_clusters": {"merge_gap_ns": 2500.0}},
     ["hit_merged"], ["hit_merged"], None),
]


@pytest.fixture(scope="module")
def v1725_rich(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("diff_cfg_v1725")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from utils import write_v1725_run

    run_dir = write_v1725_run(tmp / "DAQB", "run_cfgb", n_events=24,
                              n_samples=64)
    return tmp, (tmp / "DAQB", run_dir)


def _drive_v1725(v1725_rich, sweep_id, cfg, names, side):
    tmp, (root, run_dir) = v1725_rich
    run_id = os.path.basename(str(run_dir))
    store = tmp / f"store_{side}_{sweep_id}"
    if side == "ref":
        base._import_reference()
        full = {"wave_length": 64}
        full.update(cfg or {})
        ctx = base._build_ref_context(store, root, "v1725", full)
        import numpy as _np
        from waveform_analysis.core.processing.dtypes import (
            create_record_dtype,
        )

        ctx._plugins["st_waveforms"].output_dtype = _np.dtype(
            create_record_dtype(64)
        )
    else:
        ctx = base._build_our_context(store, root, "v1725", cfg)
    return _materialize_names(ctx, run_id, names)


@pytest.fixture(scope="module")
def v1725_defaults(v1725_rich):
    union = sorted({n for _, _, names, _, _ in V1725_SWEEPS for n in names})
    return _drive_v1725(v1725_rich, "defaults", None, union, "ours")


@pytest.mark.parametrize(
    "sweep_id,cfg,names,diff_names,atol_overrides",
    V1725_SWEEPS, ids=[s[0] for s in V1725_SWEEPS],
)
def test_v1725_config_sweep_parity(v1725_rich, v1725_defaults, sweep_id,
                                   cfg, names, diff_names, atol_overrides):
    atol_overrides = {**DEFAULT_ATOL_OVERRIDES, **(atol_overrides or {})}
    ours = _drive_v1725(v1725_rich, sweep_id, cfg, names, "ours")
    for name in diff_names:
        assert _rows_differ(name, v1725_defaults[name], ours[name]), (
            f"sweep '{sweep_id}' did not change '{name}' vs defaults — "
            "option may be silently ignored"
        )
    ref = _drive_v1725(v1725_rich, sweep_id, cfg, names, "ref")
    for name in names:
        _compare_any(name, ref[name], ours[name], atol_overrides,
                     pair_tag="v1725")


def _compare_any(name, ref, ours, atol_overrides, pair_tag="vx2730"):
    """Dispatch to the base module's comparator for this data name."""
    if name == "df":
        base._assert_df(({"df": ref}, {"df": ours}))
    elif name == "df_events":
        base._assert_df_events(({"df_events": ref}, {"df_events": ours}))
    elif name == "hit_grouped":
        base._assert_grouped_df(
            ({"hit_grouped": ref}, {"hit_grouped": ours}), "hit_grouped"
        )
    elif name == "df_paired":
        base._assert_df_paired(({"df_paired": ref}, {"df_paired": ours}))
    else:
        base._compare_structured(name, ref, ours, pair_tag=pair_tag,
                                 atol_overrides=atol_overrides)
