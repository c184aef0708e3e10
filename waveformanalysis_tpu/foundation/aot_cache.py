"""Persistent AOT (traced program) cache for fused device programs.

The persistent XLA compilation cache (foundation/compile_cache.py) removes
the *compile* cost across processes, but it keys on HLO — which only exists
AFTER jax has re-traced and re-lowered the Python program. That re-trace is
pure host-side Python work (~0.5 s for the 4-member fused bundle on this
host) and runs in EVERY fresh process: each CLI invocation, every
process-pool batch worker, every benchmark cold run. The reference pays no
such tax (its per-plugin NumPy has no trace step), so our fresh-process
cold numbers carry it as dead weight.

This module persists the traced+lowered program itself via ``jax.export``
(StableHLO serialization): the first process to trace a fused-bundle
program exports it in the background; later processes deserialize (~1 ms)
and jump straight to the XLA executable cache. Outputs are bit-identical —
the deserialized module IS the lowering the tracing process produced
(asserted in tests/test_aot_cache.py).

Keying: sha1 over (package version, jax version, x64 flag, backend
platform, the fusion program key — members + device-relevant config
values —, member plugin versions, and the argument shapes/dtypes). Plugin
versions make a kernel change invalidate stale programs the same way it
invalidates data caches through lineage.

Policy mirrors the XLA compile cache: default ON for accelerator backends,
opt-in on CPU (``WFA_AOT_CACHE_DIR``), global off via ``WFA_NO_AOT_CACHE``.
It lives beside the XLA cache: in ``$JAX_COMPILATION_CACHE_DIR/wfa_aot``
when that variable is set, else in ``<checkout>/.jax_cache/aot``.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import pickle
import tempfile
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

from waveformanalysis_tpu.foundation.compile_cache import (
    CACHE_ROOT,
    _configured_platform,
)

logger = logging.getLogger(__name__)

# beside the XLA compile cache (foundation/compile_cache.py)
DEFAULT_CACHE_DIR: Optional[str] = (
    str(CACHE_ROOT / "aot") if CACHE_ROOT is not None else None
)

# serialization-format epoch: bump to orphan every existing entry
_FORMAT = 1

_pending: "set[threading.Thread]" = set()
_pending_lock = threading.Lock()
_disabled_for_process = False


def cache_dir() -> Optional[str]:
    """Active cache directory, or None when disabled for this process.

    Same backend policy as the XLA compile cache: accelerator backends get
    it by default (their processes are latency-bound on cold start); the
    CPU backend opts in via ``WFA_AOT_CACHE_DIR`` so tests and host-only
    tools don't write caches implicitly.
    """
    if _disabled_for_process or os.environ.get("WFA_NO_AOT_CACHE"):
        return None
    env_dir = os.environ.get("WFA_AOT_CACHE_DIR")
    if env_dir:
        return env_dir
    if _configured_platform() == "cpu":
        return None
    xla_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if xla_dir:
        return os.path.join(xla_dir, "wfa_aot")
    return DEFAULT_CACHE_DIR


def _export_kwargs() -> dict:
    """jax.export options for the fused programs.

    Pallas-Triton kernels lower to the ``__gpu$xla.gpu.triton`` custom
    call, which jax.export refuses by default because Triton IR carries no
    cross-version stability guarantee. Entries here are keyed on the jax
    version (see ``digest``'s callers), so a blob is only ever reloaded by
    the jax that wrote it: allow that one custom call."""
    from jax import export

    return {"disabled_checks": [
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
    ]}


def digest(parts: Tuple[Any, ...]) -> str:
    """Stable content key over canonical reprs of the key parts."""
    h = hashlib.sha1()
    h.update(repr((_FORMAT,) + parts).encode())
    return h.hexdigest()


def _paths(base: str, key: str) -> Tuple[Path, Path]:
    d = Path(base)
    return d / f"{key}.stablehlo", d / f"{key}.payload.pkl"


def load(key: str) -> Optional[Tuple[Any, Any]]:
    """Return (jax.export.Exported, payload) for ``key``, or None.

    Any failure (missing file, stale serialization version, jax refusing
    the blob) degrades to a miss — the caller re-traces and overwrites.
    """
    base = cache_dir()
    if base is None:
        return None
    prog_path, payload_path = _paths(base, key)
    try:
        blob = prog_path.read_bytes()
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
    except OSError:
        return None
    except Exception as exc:  # corrupt payload
        logger.warning("aot cache entry %s unreadable: %s", key, exc)
        return None
    try:
        from jax import export

        exported = export.deserialize(blob)
    except Exception as exc:
        logger.warning("aot cache deserialize failed for %s: %s", key, exc)
        return None
    return exported, payload


def _atomic_write(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_async(key: str, jit_fn: Any, arg_specs: Tuple[Any, ...],
               payload: Any) -> None:
    """Export ``jit_fn`` at ``arg_specs`` and persist it, off-thread.

    Export re-traces, but against the jit object's warm jaxpr cache
    (measured ~2x cheaper than the cold trace) and OFF the caller's
    critical path — the expensive first process hides it behind whatever
    it does next. Lowering never touches the device. ``flush()`` joins
    pending writes; an atexit hook does a bounded flush so SHORT-LIVED
    processes (CLI invocations, batch workers — the cache's target
    audience) don't kill the daemon export thread before it writes:
    without it a fresh-process run can exit before the export and leave
    the layer silently inert. A torn write is replaced atomically or
    degrades to a miss.
    """
    global _disabled_for_process
    base = cache_dir()
    if base is None:
        return
    _ensure_atexit_flush()

    def work() -> None:
        global _disabled_for_process
        try:
            from jax import export

            exported = export.export(
                jit_fn, **_export_kwargs()
            )(*arg_specs)
            blob = exported.serialize()
            os.makedirs(base, exist_ok=True)
            prog_path, payload_path = _paths(base, key)
            _atomic_write(payload_path, pickle.dumps(payload))
            _atomic_write(prog_path, blob)
        except Exception as exc:
            # e.g. a backend jax.export cannot lower for: disable quietly
            # for the rest of the process instead of failing every bundle
            logger.warning("aot cache export failed (%s); disabling for "
                           "this process", exc)
            _disabled_for_process = True
        finally:
            with _pending_lock:
                _pending.discard(threading.current_thread())

    t = threading.Thread(target=work, name="wfa-aot-export", daemon=True)
    with _pending_lock:
        _pending.add(t)
    t.start()


def flush(timeout: Optional[float] = 30.0) -> None:
    """Join pending export writes (test determinism + atexit)."""
    with _pending_lock:
        threads = list(_pending)
    for t in threads:
        t.join(timeout)


_atexit_registered = False


def _ensure_atexit_flush() -> None:
    """Register a one-time bounded flush at interpreter exit.

    Exports run on daemon threads so they never block a long-lived
    process; the hook gives short-lived processes the ~0.5 s the export
    needs (bounded — a hung write can delay exit by at most the timeout).
    """
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(flush, 30.0)
