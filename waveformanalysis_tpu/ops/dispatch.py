"""Kernel choice by platform: the one place that maps a device to kernels.

Each op has a plain XLA formulation that runs on every backend, and some
have a hand-written GPU kernel (ops/scan_kernels.py, Pallas through
Triton). ``auto`` resolves through ``KERNELS``; an explicit ``xla`` or
``scan`` is taken as given. There is no fallback: a GPU kernel that fails
to compile raises, and ``scan`` on a platform without the kernel fails in
its lowering.
"""

from __future__ import annotations

from typing import Optional

import jax

OPS = ("peaks", "hits", "sosfiltfilt")
BACKENDS = ("auto", "xla", "scan")

_XLA = {op: "xla" for op in OPS}

KERNELS = {
    "gpu": {"peaks": "scan", "hits": "scan", "sosfiltfilt": "scan"},
    "cpu": _XLA,
}


def kernel_for(op: str, requested: str = "auto",
               platform: Optional[str] = None) -> str:
    """Resolve ``requested`` ("auto" | "xla" | "scan") for ``op``.

    ``platform`` defaults to ``jax.default_backend()``; a platform missing
    from ``KERNELS`` gets the plain XLA formulations.
    """
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if requested not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {requested!r} for {op}; "
            f"expected one of {BACKENDS}"
        )
    if requested != "auto":
        return requested
    platform = platform or jax.default_backend()
    return KERNELS.get(platform, _XLA)[op]
