"""Distributed time-sorted merge: records stay sharded across the mesh.

SURVEY §7 "hard parts" calls for a multi-shard sort-merge of records
"without materializing everything on one device". The reference's analog is
the host-side ordered chunk merge in its streaming executor
(reference: waveform_analysis/core/plugins/core/streaming.py:740-880) and
the records lexsort merge (records_builder.py:115-120) — both single-host,
single-array operations.

Design: a block odd-even transposition sort (merge-split) over
the mesh axis.

1. Each shard stable-sorts its rows locally by the composite key
   (one ``jnp.lexsort`` per shard, fully parallel).
2. P phases of neighbor merge-split: in even phases shard pairs (0,1),
   (2,3), ... exchange their full blocks over ICI via ``ppermute``; in odd
   phases pairs (1,2), (3,4), ... do. Each pair concatenates in canonical
   (lower-shard-first) order, stable-sorts the doubled block, and the lower
   shard keeps the low half, the upper shard the high half. After P phases
   the concatenation of shards is globally sorted (classical block
   odd-even transposition result), with every shard still holding exactly
   its original row count.

Every step is O(m log m) local work + one shard-sized ICI exchange; no
device ever holds more than 2 shards of rows. Ties across shards resolve
identically on both sides of a pair because both build the same
canonical-order concatenation (required for stable duplicate handling).

Timestamps are int64 picoseconds, so the kernels trace under a scoped x64
context like the device grouping kernels (ops/grouping_device.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SORTED_MERGE_VERSION = "sorted-merge-v1"


def _lexsort_order(cols: Dict[str, jax.Array], key_names: Sequence[str]):
    """Stable sort order; first name in ``key_names`` is the primary key."""
    # jnp.lexsort uses the LAST key as primary, numpy-style
    keys = tuple(cols[k] for k in reversed(list(key_names)))
    return jnp.lexsort(keys)


def _apply_order(cols: Dict[str, jax.Array], order: jax.Array):
    return {k: v[order] for k, v in cols.items()}


def make_sharded_time_sort(
    mesh: Mesh,
    key_names: Sequence[str],
    axis: str = "data",
):
    """Build the jitted sharded sort for a fixed mesh/axis/key set.

    Returns ``fn(cols) -> cols`` where ``cols`` is a dict of equal-length
    arrays sharded on the leading dim over ``axis``; output is globally
    sorted by ``key_names`` (first = primary) across the shard order, same
    sharding. Trace under an x64 context for int64 keys.
    """
    n_shards = mesh.shape[axis]
    key_names = list(key_names)

    def merge_phase(cols: Dict[str, jax.Array], parity: int):
        perm: List[Tuple[int, int]] = []
        for a in range(parity, n_shards - 1, 2):
            perm.append((a, a + 1))
            perm.append((a + 1, a))
        if not perm:
            return cols
        received = {
            k: jax.lax.ppermute(v, axis, perm) for k, v in cols.items()
        }
        i = jax.lax.axis_index(axis)
        if parity == 0:
            partner = jnp.where(i % 2 == 0, i + 1, i - 1)
        else:
            partner = jnp.where(i % 2 == 0, i - 1, i + 1)
        has_partner = (partner >= 0) & (partner <= n_shards - 1)
        keep_low = i < partner

        m = next(iter(cols.values())).shape[0]
        # canonical lower-shard-first concatenation on BOTH sides of the
        # pair, so stable tie resolution is identical and no row is
        # duplicated or dropped
        cat = {
            k: jnp.concatenate([
                jnp.where(keep_low, cols[k], received[k]),
                jnp.where(keep_low, received[k], cols[k]),
            ])
            for k in cols
        }
        order = _lexsort_order(cat, key_names)
        low = {k: v[order[:m]] for k, v in cat.items()}
        high = {k: v[order[m:]] for k, v in cat.items()}
        merged = {
            k: jnp.where(keep_low, low[k], high[k]) for k in cols
        }
        return {
            k: jnp.where(has_partner, merged[k], cols[k]) for k in cols
        }

    def local(cols: Dict[str, jax.Array]):
        cols = _apply_order(cols, _lexsort_order(cols, key_names))
        for phase in range(n_shards):
            cols = merge_phase(cols, phase % 2)
        return cols

    if n_shards == 1:
        def single(cols):
            return _apply_order(cols, _lexsort_order(cols, key_names))

        return jax.jit(single)

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_time_sort(
    cols: Dict[str, np.ndarray],
    key_names: Sequence[str],
    mesh: Mesh,
    axis: str = "data",
    pad_key: str = "timestamp",
) -> Dict[str, np.ndarray]:
    """Host-convenience wrapper: pad to the shard multiple, sort, unpad.

    Padding rows carry the maximum key value so they sort to the global
    tail and slice off cleanly. Host arrays in, host arrays out; the sort
    itself runs sharded on the mesh (``make_sharded_time_sort``).
    """
    names = list(cols.keys())
    n = len(cols[names[0]])
    if n == 0:
        return {k: np.asarray(v) for k, v in cols.items()}
    n_shards = mesh.shape[axis]
    padded_n = ((n + n_shards - 1) // n_shards) * n_shards
    pad = padded_n - n

    with jax.enable_x64(True):
        dev_cols = {}
        for k in names:
            arr = np.asarray(cols[k])
            if pad:
                fill_value = (
                    np.iinfo(arr.dtype).max
                    if k == pad_key and np.issubdtype(arr.dtype, np.integer)
                    else 0
                )
                fill = np.full((pad,) + arr.shape[1:], fill_value, arr.dtype)
                arr = np.concatenate([arr, fill])
            dev_cols[k] = jax.device_put(
                arr, NamedSharding(mesh, P(axis, *([None] * (arr.ndim - 1))))
            )
        fn = make_sharded_time_sort(mesh, key_names, axis=axis)
        out = jax.device_get(fn(dev_cols))
    return {k: np.asarray(v)[:n] for k, v in out.items()}
