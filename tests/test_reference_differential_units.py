"""Function-level differential oracles: chunk time algebra + config
resolution against the ACTUAL reference package.

Complements tests/test_reference_differential.py (pipeline-level): the
chunk time-algebra primitives (SURVEY §2.2) and the config resolver
precedence chain (SURVEY §2.4) are exercised here with randomized inputs
on BOTH implementations and compared output-for-output.
"""

import sys

import numpy as np
import pytest

REF_PATH = "/root/reference"

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def refchunk():
    if REF_PATH not in sys.path:
        sys.path.insert(0, REF_PATH)
    try:
        from waveform_analysis.core.processing import chunk as refchunk
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference package not importable: {e}")
    return refchunk


import waveformanalysis_tpu.dtypes.chunk as ourchunk  # noqa: E402


def _records(rng, n, sorted_time=True, with_gap=False):
    """Random structured rows with the chunk model's field contract."""
    dt = np.dtype([
        ("time", "<i8"), ("dt", "<i4"), ("length", "<i4"),
        ("channel", "<i2"), ("value", "<f4"),
    ])
    arr = np.zeros(n, dtype=dt)
    t = np.cumsum(rng.integers(1, 2000, n))
    if with_gap and n > 4:
        t[n // 2:] += 10_000_000  # a break-threshold-sized gap
    if not sorted_time:
        t = rng.permutation(t)
    arr["time"] = t
    arr["dt"] = rng.integers(1, 5, n)
    arr["length"] = rng.integers(1, 200, n)
    arr["channel"] = rng.integers(0, 4, n)
    arr["value"] = rng.normal(size=n).astype(np.float32)
    return arr


SEEDS = [0, 1, 2]


class TestChunkAlgebraDifferential:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_endtime_family(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        a = _records(rng, 64)
        np.testing.assert_array_equal(
            refchunk.compute_endtime(a), ourchunk.compute_endtime(a)
        )
        np.testing.assert_array_equal(
            refchunk.compute_endtime(a, dt=3.0),
            ourchunk.compute_endtime(a, dt=3.0),
        )
        ra = refchunk.add_endtime_field(a.copy())
        oa = ourchunk.add_endtime_field(a.copy())
        np.testing.assert_array_equal(ra["endtime"], oa["endtime"])
        np.testing.assert_array_equal(
            refchunk.get_endtime(ra), ourchunk.get_endtime(oa)
        )

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("strict", [False, True])
    def test_select_time_range(self, refchunk, seed, strict):
        rng = np.random.default_rng(seed)
        a = _records(rng, 96)
        t0 = int(a["time"][20])
        t1 = int(a["time"][70])
        for start, end in ((t0, t1), (None, t1), (t0, None), (None, None)):
            r = refchunk.select_time_range(a, start, end, strict=strict)
            o = ourchunk.select_time_range(a, start, end, strict=strict)
            np.testing.assert_array_equal(r, np.asarray(o))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_clip_to_time_range(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        a = _records(rng, 48)
        t0 = int(a["time"][10]) + 1
        t1 = int(a["time"][40])
        r = refchunk.clip_to_time_range(a, t0, t1)
        o = np.asarray(ourchunk.clip_to_time_range(a, t0, t1))
        assert r.dtype.names == o.dtype.names
        for f in r.dtype.names:
            np.testing.assert_array_equal(r[f], o[f], err_msg=f"clip.{f}")

    @pytest.mark.parametrize("seed", SEEDS)
    def test_split_by_count(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        a = _records(rng, 100)
        r = list(refchunk.split_by_count(a, 17))
        o = list(ourchunk.split_by_count(a, 17))
        assert len(r) == len(o)
        for (rc, _ri), (oc, _oi) in zip(r, o):
            np.testing.assert_array_equal(rc, np.asarray(oc))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_split_by_time(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        a = _records(rng, 100)
        r = list(refchunk.split_by_time(a, 25_000))
        o = list(ourchunk.split_by_time(a, 25_000))
        assert len(r) == len(o)
        for (rc, _ri), (oc, _oi) in zip(r, o):
            np.testing.assert_array_equal(rc, np.asarray(oc))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_split_by_breaks(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        a = _records(rng, 80, with_gap=True)
        r = list(refchunk.split_by_breaks(a, break_threshold_ps=5_000_000))
        o = list(ourchunk.split_by_breaks(a, break_threshold_ps=5_000_000))
        assert len(r) == len(o) >= 2
        for (rc, _ri), (oc, _oi) in zip(r, o):
            np.testing.assert_array_equal(rc, np.asarray(oc))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_rechunk(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        parts = [_records(rng, int(n)) for n in rng.integers(3, 40, 6)]
        base = 0
        fixed = []
        for p in parts:  # make times globally increasing across parts
            p = p.copy()
            p["time"] += base
            base = int(p["time"].max()) + 1000
            fixed.append(p)
        def as_chunks(mod, parts):
            return iter([
                (p, mod.ChunkInfo(
                    start_time=int(p["time"].min()),
                    end_time=int(mod.get_endtime(p).max()),
                    n_records=len(p), chunk_i=i,
                ))
                for i, p in enumerate(parts)
            ])

        r = list(refchunk.rechunk(as_chunks(refchunk, fixed), target_size=25))
        o = list(ourchunk.rechunk(as_chunks(ourchunk, fixed), target_size=25))
        assert len(r) == len(o)
        for (rc, _ri), (oc, _oi) in zip(r, o):
            np.testing.assert_array_equal(rc, np.asarray(oc))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_merge_and_sort(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        parts = [_records(rng, 20, sorted_time=False) for _ in range(4)]
        r = refchunk.merge_chunks(iter(parts), sort=True)
        o = np.asarray(ourchunk.merge_chunks(iter(parts), sort=True))
        np.testing.assert_array_equal(r, o)
        a = _records(rng, 50, sorted_time=False)
        np.testing.assert_array_equal(
            refchunk.sort_by_time(a), np.asarray(ourchunk.sort_by_time(a))
        )

    @pytest.mark.parametrize("seed", SEEDS)
    def test_validation_checks_agree(self, refchunk, seed):
        rng = np.random.default_rng(seed)
        good = _records(rng, 40)
        bad = _records(rng, 40, sorted_time=False)
        for a in (good, bad):
            assert (
                refchunk.check_monotonic(a).is_valid
                == ourchunk.check_monotonic(a).is_valid
            )
            assert (
                refchunk.check_no_overlap(a).is_valid
                == ourchunk.check_overlap(a).is_valid
            )
            # ref check_sorted_by_time = sorted AND non-overlapping
            ours_combined = bool(
                ourchunk.is_sorted_by_time(a)
                and ourchunk.check_overlap(a).is_valid
            )
            assert refchunk.check_sorted_by_time(a).is_valid == ours_combined

    def test_unit_helpers(self, refchunk):
        for t, dt in ((1000, 2), (999, 2), (0, 4), (12345, 3)):
            assert refchunk.time_to_samples(t, dt) == \
                ourchunk.time_to_samples(t, dt)
            assert refchunk.samples_to_time(t, dt) == \
                ourchunk.samples_to_time(t, dt)

    def test_defaults_match(self, refchunk):
        assert refchunk.DEFAULT_CHUNK_SIZE == ourchunk.DEFAULT_CHUNK_SIZE
        assert (
            refchunk.DEFAULT_BREAK_THRESHOLD_PS
            == ourchunk.DEFAULT_BREAK_THRESHOLD_PS
        )


class TestConfigResolutionDifferential:
    """The precedence chain (explicit plugin-scoped > dotted > global >
    adapter-inferred > default) resolved by BOTH packages over the same
    config dicts must agree value-for-value (SURVEY §2.4)."""

    CASES = [
        # (context config, expectation comment)
        ({}, "pure defaults"),
        ({"height": 55.0}, "global key"),
        ({"hit.height": 60.0}, "dotted key"),
        ({"hit": {"height": 65.0}}, "plugin-scoped dict"),
        ({"hit": {"height": 65.0}, "hit.height": 60.0, "height": 55.0},
         "plugin dict beats dotted beats global"),
        ({"hit.height": 60.0, "height": 55.0}, "dotted beats global"),
    ]

    @pytest.fixture(scope="class")
    def both(self, refchunk, tmp_path_factory):
        # refchunk fixture guarantees the reference imports
        from waveform_analysis.core.context import Context as RefCtx
        from waveform_analysis.core.plugins import profiles

        from waveformanalysis_tpu.context.context import Context as OurCtx
        from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

        def build(cfg):
            tmp = tmp_path_factory.mktemp("cfgdiff")
            base = {"show_progress": False}
            base.update(cfg)
            r = RefCtx(storage_dir=str(tmp / "r"), config=dict(base))
            r.register(*profiles.get_profile("cpu")())
            o = OurCtx(storage_dir=str(tmp / "o"), config=dict(base))
            o.register(*default_plugins())
            return r, o

        return build

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_precedence_matrix(self, both, case):
        cfg, why = self.CASES[case]
        rctx, octx = both(cfg)
        rv = rctx.get_config(rctx._plugins["hit"], "height")
        ov = octx.get_config(octx._plugins["hit"], "height")
        assert rv == ov, f"{why}: ref={rv} ours={ov}"

    def test_set_config_after_registration(self, both):
        rctx, octx = both({})
        for ctx in (rctx, octx):
            ctx.set_config({"hit": {"height": 42.0}})
        assert (
            rctx.get_config(rctx._plugins["hit"], "height")
            == octx.get_config(octx._plugins["hit"], "height")
            == 42.0
        )

    def test_adapter_inferred_dt(self, both):
        rctx, octx = both({"daq_adapter": "vx2730"})
        rv = rctx.get_config(rctx._plugins["hit"], "dt")
        ov = octx.get_config(octx._plugins["hit"], "dt")
        assert rv == ov, f"adapter-inferred dt: ref={rv} ours={ov}"
