"""Device mesh construction helpers.

The reference scales with thread/process pools on one host
(reference: waveform_analysis/core/execution/manager.py:35); the device
equivalent is a jax device Mesh. The canonical layout here is 1-D
``("data",)`` — chunks of the time-sorted record stream are the unit of
data parallelism — with an optional 2-D ``("data", "channel")`` layout when
channel-parallel decode dominates.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a Mesh over the first ``n_devices`` devices.

    Default: 1-D data-parallel mesh over all devices.
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devs)} available"
            )
        devs = devs[:n_devices]
    if shape is None:
        if len(axis_names) == 1:
            shape = (len(devs),)
        else:
            raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"Mesh shape {shape} != device count {len(devs)}")
    grid = np.array(devs).reshape(shape)
    return Mesh(grid, axis_names)


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (event/chunk) dimension across the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_shards(n: int, n_shards: int) -> int:
    """Events must pad to a multiple of the shard count for even layouts."""
    return ((n + n_shards - 1) // n_shards) * n_shards
