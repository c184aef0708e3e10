"""Device-side compaction of fixed-capacity slot tables.

The peak/hit kernels emit (n, K) slot tables (K = device capacity per
waveform) where typically only ~1 slot per row is valid. Fetching the full
tables through the device→host link moves mostly padding. The ops here
front-pack valid slots ON DEVICE so the host fetches only real
rows: ``compact_slots`` inside jit, then an eager ``[:count]`` slice whose
transfer is proportional to the valid count.

Used by the fused bundle executor (context/fusion.py) and the standalone
hit / hit_threshold plugin computes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def compact_slots(stage_out, fields: Sequence[str]):
    """Device-side: front-pack valid (n, K) slots into an (n*K, F+1) i32
    matrix (inside jit).

    Column 0 is the source-row index; columns 1.. are ``fields`` in order,
    f32 leaves bitcast to i32. Valid slots land in row-major order — exactly
    the order ``np.nonzero(valid)`` yields on host — so downstream columns
    are bit-identical to the host-compaction path. Rows past the returned
    count are zero.

    Implementation: one multi-operand device sort keyed on (invalid, flat
    index), chosen over a row scatter and per-column scatters; not yet
    re-measured on the GPU.
    """
    import jax
    import jax.numpy as jnp

    valid = stage_out["valid"]
    n, K = valid.shape
    nK = n * K
    vflat = valid.reshape(-1)
    rows = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None], (n, K)
    ).reshape(-1)
    cols = [rows]
    for f in fields:
        leaf = stage_out[f].reshape(-1)
        if leaf.dtype == jnp.float32:
            leaf = jax.lax.bitcast_convert_type(leaf, jnp.int32)
        else:
            leaf = leaf.astype(jnp.int32)
        cols.append(leaf)
    skey = jnp.arange(nK, dtype=jnp.int32) + jnp.where(vflat, 0, nK)
    sorted_ops = jax.lax.sort(
        (skey, *cols), dimension=0, num_keys=1
    )
    count = jnp.sum(vflat.astype(jnp.int32))
    # zero the tail so dropped-slot values never leak into a transfer
    ok = jnp.arange(nK, dtype=jnp.int32) < count
    mat = jnp.stack(
        [jnp.where(ok, c, 0) for c in sorted_ops[1:]], axis=1
    )
    return mat, count


def decode_slot_matrix(
    chunk: np.ndarray, fields: Sequence[str], dtypes: Sequence[str]
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Host-side: (rows, {field: column}) from a fetched compact matrix."""
    rows = chunk[:, 0]
    slots: Dict[str, np.ndarray] = {}
    for j, (f, dt) in enumerate(zip(fields, dtypes)):
        col = np.ascontiguousarray(chunk[:, j + 1])
        slots[f] = col.view(np.float32) if dt == "float32" else col
    return rows, slots
