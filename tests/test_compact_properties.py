"""Property-based invariants for the minimal-transfer machinery.

The device-side slot compaction and the flat packed-transfer codec are the
load-bearing pieces of every device->host fetch; these pin their laws over
randomized inputs (hypothesis):

- compact_slots front-packs valid slots in EXACTLY np.nonzero order (the
  host-compaction oracle), reports exact counts, and zero-fills the tail;
- f32 payloads survive the i32 bitcast round trip bit-for-bit (incl. NaN,
  infinities, -0.0, denormals);
- the pack/unpack codec is the identity on mixed-dtype pytrees;
- batched run-boundary splitting by searchsorted recovers each run's rows.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from waveformanalysis_tpu.context.fusion import _pack_leaves, _unpack_host
from waveformanalysis_tpu.ops.compact import compact_slots, decode_slot_matrix


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(1, 40),
    k=st.integers(1, 9),
    seed=st.integers(0, 2**31 - 1),
)
def test_compact_matches_nonzero_order(n, k, seed):
    rng = np.random.default_rng(seed)
    valid = rng.random((n, k)) < rng.uniform(0.0, 1.0)
    pos = rng.integers(-1000, 1000, (n, k)).astype(np.int32)
    height = rng.standard_normal((n, k)).astype(np.float32)
    stage = {
        "valid": jnp.asarray(valid),
        "position": jnp.asarray(pos),
        "height": jnp.asarray(height),
    }
    mat, count = compact_slots(stage, ("position", "height"))
    mat, count = np.asarray(mat), int(count)

    assert count == int(valid.sum())
    rows_ref, cols_ref = np.nonzero(valid)
    rows, slots = decode_slot_matrix(
        mat[:count], ("position", "height"), ("int32", "float32")
    )
    np.testing.assert_array_equal(rows, rows_ref)
    np.testing.assert_array_equal(slots["position"], pos[rows_ref, cols_ref])
    np.testing.assert_array_equal(slots["height"], height[rows_ref, cols_ref])
    # dropped-slot values never leak past the count
    assert np.all(mat[count:] == 0)


def test_compact_bitcast_preserves_special_floats():
    specials = np.array(
        [np.nan, np.inf, -np.inf, -0.0, 0.0, np.float32(1e-42), 3.5],
        dtype=np.float32,
    )
    n = len(specials)
    stage = {
        "valid": jnp.ones((n, 1), bool),
        "height": jnp.asarray(specials.reshape(n, 1)),
    }
    mat, count = compact_slots(stage, ("height",))
    _rows, slots = decode_slot_matrix(
        np.asarray(mat)[: int(count)], ("height",), ("float32",)
    )
    np.testing.assert_array_equal(
        slots["height"].view(np.int32), specials.view(np.int32)
    )


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    shapes=st.lists(
        st.tuples(st.integers(0, 7), st.sampled_from(
            ["float32", "int32", "int16", "int8", "bool"]
        )),
        min_size=1, max_size=6,
    ),
)
def test_pack_unpack_identity(seed, shapes):
    rng = np.random.default_rng(seed)
    tree = {}
    for i, (n, dt) in enumerate(shapes):
        if dt == "float32":
            leaf = rng.standard_normal(n).astype(np.float32)
        elif dt == "bool":
            leaf = rng.random(n) < 0.5
        else:
            info = np.iinfo(dt)
            leaf = rng.integers(info.min, info.max, n).astype(dt)
        tree[f"leaf{i}"] = jnp.asarray(leaf)
    flat, spec = _pack_leaves(tree)
    out = _unpack_host(np.asarray(flat), spec)
    for key, leaf in tree.items():
        got = out[key]
        want = np.asarray(leaf)
        if want.dtype == np.float32:
            np.testing.assert_array_equal(
                got.view(np.int32), want.view(np.int32), err_msg=key
            )
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=key)


def test_pack_rejects_64bit_leaves():
    class _Leaf:
        dtype = np.dtype(np.int64)
        shape = (3,)

    with pytest.raises(TypeError, match="64-bit"):
        _pack_leaves({"x": jnp.zeros(3, jnp.float32), "t": _Leaf()})


@settings(max_examples=25, deadline=None)
@given(
    sizes=st.lists(st.integers(0, 30), min_size=1, max_size=6),
    k=st.integers(1, 4),
    seed=st.integers(0, 2**31 - 1),
)
def test_batched_boundary_split_recovers_runs(sizes, k, seed):
    """Concatenate per-run slot tables, compact once, split by searchsorted
    on the global row index (the _dispatch_group recipe): every run gets
    exactly its own valid slots, rebased."""
    rng = np.random.default_rng(seed)
    total = sum(sizes)
    if total == 0:
        return
    valid = rng.random((total, k)) < 0.4
    val = rng.integers(0, 10**6, (total, k)).astype(np.int32)
    stage = {"valid": jnp.asarray(valid), "v": jnp.asarray(val)}
    mat, count = compact_slots(stage, ("v",))
    rows, slots = decode_slot_matrix(
        np.asarray(mat)[: int(count)], ("v",), ("int32",)
    )

    off = 0
    for n_r in sizes:
        lo = int(np.searchsorted(rows, off))
        hi = int(np.searchsorted(rows, off + n_r))
        rows_r = rows[lo:hi] - off
        vals_r = slots["v"][lo:hi]
        ref_rows, ref_cols = np.nonzero(valid[off:off + n_r])
        np.testing.assert_array_equal(rows_r, ref_rows)
        np.testing.assert_array_equal(
            vals_r, val[off:off + n_r][ref_rows, ref_cols]
        )
        off += n_r
