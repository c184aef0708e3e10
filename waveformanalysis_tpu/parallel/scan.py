"""Sharded time-axis execution over a device mesh.

Device replacement for the reference's chunk-parallel thread/process
pools (reference: waveform_analysis/core/plugins/core/streaming.py:740):
chunks of the time-sorted record stream become shards of the event axis
across a 1-D ``("data",)`` mesh; windowed kernels receive halo rows from
neighboring shards via ``ppermute``; run statistics combine with ``psum``
and return replicated. Breaks/segments travel as a segment-id array so
stateful logic resets inside the kernel, and outputs clip to each shard's
main window exactly like the host streaming engine clips chunks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_halo_exchange(
    x: jax.Array, halo: int, axis_name: str = "data"
) -> Tuple[jax.Array, jax.Array]:
    """Exchange boundary rows with ring neighbors inside shard_map.

    Returns (left_halo, right_halo): the last ``halo`` rows of the left
    neighbor and the first ``halo`` rows of the right neighbor, zeroed at
    the non-periodic ends (shard 0 left, shard N-1 right).
    """
    n_shards = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    right_perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left_perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    # our tail -> right neighbor's left halo
    left_halo = jax.lax.ppermute(x[-halo:], axis_name, right_perm)
    # our head -> left neighbor's right halo
    right_halo = jax.lax.ppermute(x[:halo], axis_name, left_perm)
    left_halo = jnp.where(idx == 0, jnp.zeros_like(left_halo), left_halo)
    right_halo = jnp.where(
        idx == n_shards - 1, jnp.zeros_like(right_halo), right_halo
    )
    return left_halo, right_halo


def make_sharded_pipeline(
    mesh: Mesh,
    kernel: Callable[..., Dict[str, jax.Array]],
    n_inputs: int,
    out_keys: Tuple[str, ...],
    stats_keys: Tuple[str, ...] = (),
    axis_name: str = "data",
    halo: int = 0,
):
    """Jitted SPMD wrapper around a per-shard kernel.

    kernel(*arrays[, left_halo=, right_halo=]) must return a dict whose keys
    are exactly ``out_keys``; entries named in ``stats_keys`` are scalars,
    psum-reduced across the mesh and returned replicated; everything else
    stays sharded on the event axis like the inputs.
    """
    stats = set(stats_keys)

    def local(*arrays: jax.Array) -> Dict[str, jax.Array]:
        kwargs = {}
        if halo > 0:
            left, right = shard_halo_exchange(arrays[0], halo, axis_name)
            kwargs = {"left_halo": left, "right_halo": right}
        out = kernel(*arrays, **kwargs)
        missing = set(out_keys) - set(out)
        if missing:
            raise ValueError(f"sharded kernel missing outputs: {sorted(missing)}")
        for key in stats:
            out[key] = jax.lax.psum(out[key], axis_name)
        return {k: out[k] for k in out_keys}

    out_specs = {k: (P() if k in stats else P(axis_name)) for k in out_keys}
    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(P(axis_name) for _ in range(n_inputs)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sharded)


def shard_table_arrays(
    mesh: Mesh, *arrays: Any, axis_name: str = "data"
) -> Tuple[jax.Array, ...]:
    """Pad leading axes to a multiple of the shard count and device_put with
    event-axis sharding. Returns the sharded arrays (padding rows are zero;
    carry a validity column if the kernel must ignore them)."""
    n_shards = mesh.shape[axis_name]
    sharding = NamedSharding(mesh, P(axis_name))
    n = int(np.asarray(arrays[0]).shape[0])
    padded_n = ((n + n_shards - 1) // n_shards) * n_shards
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.shape[0] != n:
            raise ValueError("all arrays must share the leading event axis")
        if padded_n != n:
            pad = [(0, padded_n - n)] + [(0, 0)] * (arr.ndim - 1)
            arr = np.pad(arr, pad)
        out.append(jax.device_put(jnp.asarray(arr), sharding))
    return tuple(out)
