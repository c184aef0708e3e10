"""Device-side slot compaction in the fused bundle transfer path.

The fused executor front-packs valid (n, K) hit/peak slots ON DEVICE and
fetches only the first ``count`` rows of each compacted matrix
(context/fusion.py _compact_slots / _fetch_packed_outputs), so the link
moves real hits instead of K-slot padding. These tests pin the compaction
order to the host ``np.nonzero`` contract, the round trip through the
two-phase fetch, and overflow-counter propagation through the fused path.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from waveformanalysis_tpu.context.fusion import (  # noqa: E402
    _compact_slots,
    _fetch_packed_outputs,
    _pack_leaves,
)


def _fake_stage(n=37, K=5, seed=0):
    rng = np.random.default_rng(seed)
    valid = rng.random((n, K)) < 0.3
    # valid slots are front-loaded per row in the real kernels; the
    # compaction must not depend on that, so keep the random scatter
    return {
        "valid": jnp.asarray(valid),
        "position": jnp.asarray(
            rng.integers(0, 1000, (n, K)).astype(np.int32)
        ),
        "score": jnp.asarray(rng.normal(size=(n, K)).astype(np.float32)),
    }


def test_compact_slots_matches_nonzero_order():
    stage = _fake_stage()
    fields = ("position", "score")
    mat, count = jax.jit(
        lambda s: _compact_slots(s, fields)
    )(stage)
    mat = np.asarray(mat)
    count = int(count)

    valid = np.asarray(stage["valid"])
    rows, cols = np.nonzero(valid)
    assert count == len(rows)
    np.testing.assert_array_equal(mat[:count, 0], rows.astype(np.int32))
    np.testing.assert_array_equal(
        mat[:count, 1], np.asarray(stage["position"])[rows, cols]
    )
    np.testing.assert_array_equal(
        mat[:count, 2].view(np.float32),
        np.asarray(stage["score"])[rows, cols],
    )
    # rows past count are zeroed (nothing leaks from dropped slots)
    assert not mat[count:].any()


def test_compact_slots_empty_and_full():
    n, K = 8, 3
    base = {
        "position": jnp.arange(n * K, dtype=jnp.int32).reshape(n, K),
    }
    for valid in (np.zeros((n, K), bool), np.ones((n, K), bool)):
        stage = dict(base, valid=jnp.asarray(valid))
        mat, count = _compact_slots(stage, ("position",))
        assert int(count) == int(valid.sum())
        rows, cols = np.nonzero(valid)
        np.testing.assert_array_equal(
            np.asarray(mat)[: int(count), 1],
            np.asarray(base["position"])[rows, cols],
        )


def test_two_phase_fetch_round_trip():
    stage = _fake_stage(n=19, K=4, seed=3)
    fields = ("position", "score")
    dense = {"a": jnp.arange(19, dtype=jnp.int32),
             "b": jnp.float32(2.5),
             "hit__overflow": jnp.int32(7)}

    mat, count = _compact_slots(stage, fields)
    flat, dense_spec = _pack_leaves(dense)
    spec_entry = (dense_spec, [("hit", fields, ("int32", "float32"))])
    dense_tree, slot_out = _fetch_packed_outputs(
        flat, (mat,), jnp.asarray([count]), spec_entry
    )

    np.testing.assert_array_equal(dense_tree["a"], np.arange(19))
    assert dense_tree["b"] == np.float32(2.5)
    assert int(dense_tree["hit__overflow"]) == 7

    valid = np.asarray(stage["valid"])
    rows, cols = np.nonzero(valid)
    got_rows, slots = slot_out["hit"]
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(
        slots["position"], np.asarray(stage["position"])[rows, cols]
    )
    np.testing.assert_array_equal(
        slots["score"], np.asarray(stage["score"])[rows, cols]
    )


def test_speculative_fetch_hint_paths():
    """The single-transfer fetch predicts slot counts from the previous
    call at the same site; over- and under-shooting predictions must both
    decode bit-identically (undershoot via the remedial row fetch)."""
    from waveformanalysis_tpu.context import fusion

    fields = ("position", "score")

    def run_once(seed, n, hint_key):
        stage = _fake_stage(n=n, K=6, seed=seed)
        dense = {"a": jnp.arange(n, dtype=jnp.int32)}
        mat, count = _compact_slots(stage, fields)
        flat, dense_spec = _pack_leaves(dense)
        spec_entry = (dense_spec, [("hit", fields, ("int32", "float32"))])
        dense_tree, slot_out = _fetch_packed_outputs(
            flat, (mat,), jnp.asarray([count]), spec_entry,
            hint_key=hint_key,
        )
        valid = np.asarray(stage["valid"])
        rows, cols = np.nonzero(valid)
        got_rows, slots = slot_out["hit"]
        np.testing.assert_array_equal(dense_tree["a"], np.arange(n))
        np.testing.assert_array_equal(got_rows, rows)
        np.testing.assert_array_equal(
            slots["position"], np.asarray(stage["position"])[rows, cols]
        )
        np.testing.assert_array_equal(
            slots["score"].view(np.int32),
            np.asarray(stage["score"])[rows, cols].view(np.int32),
        )
        return len(rows)

    key = ("test-site", ("hit",))
    fusion._count_hints.pop(key, None)
    c1 = run_once(seed=11, n=4000, hint_key=key)  # no hint: exact buckets
    assert fusion._count_hints[key] == (c1,)
    # same shapes, new data: speculative bucket from the recorded hint
    c2 = run_once(seed=12, n=4000, hint_key=key)
    assert fusion._count_hints[key] == (c2,)
    # force a massive undershoot: hint of 1 row -> bucket 4096 < count,
    # exercising the remedial fetch of the missing rows
    fusion._count_hints[key] = (1,)
    big_n = 4 * fusion._FETCH_BUCKET
    c3 = run_once(seed=13, n=big_n, hint_key=key)
    assert c3 > fusion._FETCH_BUCKET  # ~30% valid of big_n*6 slots
    # force an overshoot: hint far above the real count
    fusion._count_hints[key] = (big_n * 6,)
    run_once(seed=14, n=big_n, hint_key=key)


def test_fused_overflow_counter_and_policy(tmp_path):
    """A dense multi-pulse waveform overflows tiny capacity through the
    FUSED path: warn keeps going, raise raises — same as standalone
    (tests/test_chain_overflow.py covers the standalone contract)."""
    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.hit_finder import (
        ThresholdHitPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.peak_finding import (
        HitFinderPlugin,
    )
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

    n, L = 64, 256
    st = make_fake_st_waveforms(
        n_events=n, wave_length=L, pulse_height=0, polarity="positive",
        seed=1,
    )
    # paint 6 well-separated square pulses into every waveform -> 6 peaks
    wave = st["wave"].astype(np.float64)
    for k in range(6):
        lo = 20 + 30 * k
        wave[:, lo:lo + 6] += 400.0
    st["wave"] = wave.astype(np.int16)

    def make_ctx(policy):
        ctx = Context(
            storage_dir=str(tmp_path / policy),
            config={"show_progress": False, "fused_execution": True},
        )
        ctx.register(
            BasicFeaturesPlugin(), HitFinderPlugin(), ThresholdHitPlugin()
        )
        ctx.set_config({
            "hit": {
                "use_filtered": False, "use_derivative": False,
                "height": 100.0, "prominence": 50.0, "width": 2,
                "max_peaks_per_waveform": 2, "overflow_policy": policy,
            },
            "hit_threshold": {"use_filtered": False},
        })
        ctx.inject_data("overflow-run", "st_waveforms", st)
        return ctx

    with pytest.raises(ValueError, match="exceeded"):
        make_ctx("raise").get_data(
            "overflow-run", ["basic_features", "hit", "hit_threshold"]
        )

    out = make_ctx("warn").get_data(
        "overflow-run", ["basic_features", "hit", "hit_threshold"]
    )
    # capacity caps at 2 peaks per waveform
    assert len(out["hit"]) == 2 * n
