"""Persistent XLA compilation cache management.

A production framework must not pay jit-compile latency on every process
start: the reference's per-plugin NumPy has no compile step, so our "cold
run" numbers would otherwise carry XLA work the second process shouldn't
repeat. jax ships a persistent compilation cache (disk keyed by HLO
fingerprint + compile options + backend); this module turns it on once per
process so every Context/CLI/benchmark process after the first reuses
compiled executables.

Where the cache lives is decided from outside the program:

- ``JAX_COMPILATION_CACHE_DIR`` set: jax reads it itself; this module sets
  no other directory (it only lowers the entry-size/compile-time floors);
- otherwise: ``<checkout>/.jax_cache/xla`` — one fixed path (listed in
  .gitignore), never one made from a temporary name, a pid or the time. An
  installed package (no checkout around it) keeps no cache unless the
  variable names one.

Cache correctness is owned by jax/XLA (the key covers the computation and
the toolchain); our lineage hashing stays orthogonal — it keys *data*, this
keys *executables*.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_configured: Optional[str] = None

# <checkout>/.jax_cache (package dir -> repository root); None when the
# package is installed rather than run from a checkout
_CHECKOUT = Path(__file__).resolve().parents[2]
CACHE_ROOT: Optional[Path] = (
    _CHECKOUT / ".jax_cache" if (_CHECKOUT / "pyproject.toml").is_file()
    else None
)
DEFAULT_CACHE_DIR: Optional[str] = (
    str(CACHE_ROOT / "xla") if CACHE_ROOT is not None else None
)


def _configured_platform() -> str:
    """The jax platform string WITHOUT initializing a backend (config first,
    then env), so host-only Contexts never open a device."""
    try:
        import jax

        value = jax.config.jax_platforms
        if value:
            return str(value).split(",")[0]
    except Exception:  # pragma: no cover
        pass
    return (os.environ.get("JAX_PLATFORMS") or "").split(",")[0]


def ensure_compilation_cache(force: bool = False) -> Optional[str]:
    """Enable the persistent jax compilation cache (idempotent).

    Returns the active cache dir, or None if disabled/unavailable.

    Policy: on by default on accelerator backends, where a kernel compile
    costs seconds. On the CPU backend it is opt-in (``force=True`` or
    ``JAX_COMPILATION_CACHE_DIR``): compiles there are sub-second and XLA's
    CPU AOT deserializer logs noisy pseudo-feature mismatch errors on every
    load. ``WFA_NO_COMPILE_CACHE=1`` disables it globally.
    """
    global _configured
    if os.environ.get("WFA_NO_COMPILE_CACHE"):
        return None
    if _configured is not None:
        return _configured
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not force and not env_dir and _configured_platform() == "cpu":
        return None
    try:
        import jax

        if env_dir:
            path = env_dir
        elif DEFAULT_CACHE_DIR is None:
            return None
        else:
            path = DEFAULT_CACHE_DIR
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        # cache every executable: our kernels are small but latency-critical
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        _configured = path
        return path
    except Exception as exc:  # pragma: no cover - depends on jax build
        logger.warning("persistent compilation cache unavailable: %s", exc)
        return None
