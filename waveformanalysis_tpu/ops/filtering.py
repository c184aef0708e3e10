"""Digital filtering kernels: zero-phase IIR (Butterworth) and Savitzky-Golay.

Device replacement for the reference scipy filtering layer
(reference: waveform_analysis/core/plugins/builtin/cpu/filtering.py:129-260).
Numeric contract:

- BW: ``butter(order, [lo, hi], output='sos')`` + ``sosfiltfilt`` zero-phase
  forward-backward filtering with scipy's odd-reflection padding and
  ``sosfilt_zi``-scaled initial conditions; waves shorter than the pad length
  pass through unfiltered (the reference padlen guard).
- SG: ``savgol_filter(..., mode='interp')`` — interior via FIR convolution,
  edges via polynomial least-squares fits; even windows clamp down to odd.

The IIR recurrence is sequential per sample, so on device each second-order
section runs as a **log-depth associative scan over affine state maps**:
z[n] = M z[n-1] + v x[n] with M = [[-a1, 1], [-a2, 0]],
v = [b1 - a1*b0, b2 - a2*b0], y[n] = b0 x[n] + z1[n-1] (transposed DF-II).
Batched over events via vmap; compiled once per (wave_len, n_sections).
A scipy path (engine="scipy") provides the bit-exact host reference.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Any, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from waveformanalysis_tpu.ops.dispatch import kernel_for

KERNEL_VERSION = "filtering-v1"


# --------------------------------------------------------------------------
# Filter design (host, tiny, exact)
# --------------------------------------------------------------------------

def design_butterworth_sos(
    order: int, lowcut: float, highcut: float, fs: float
) -> np.ndarray:
    """Bandpass Butterworth as second-order sections (scipy design)."""
    from scipy.signal import butter

    if fs <= 0:
        raise ValueError(f"fs ({fs}) must be > 0")
    if order <= 0:
        raise ValueError(f"filter order ({order}) must be > 0")
    if lowcut <= 0 or highcut <= 0:
        raise ValueError("cutoff frequencies must be > 0")
    if lowcut >= highcut:
        raise ValueError(f"lowcut ({lowcut}) must be < highcut ({highcut})")
    if highcut >= fs / 2:
        raise ValueError(f"highcut ({highcut}) must be < Nyquist ({fs / 2})")
    return butter(order, [lowcut, highcut], btype="band", output="sos", fs=fs)


def sosfiltfilt_padlen(sos: np.ndarray) -> int:
    """scipy's default sosfiltfilt pad length."""
    n_sections = int(sos.shape[0])
    zeros_at_origin = int((sos[:, 2] == 0).sum())
    poles_at_origin = int((sos[:, 5] == 0).sum())
    return 3 * (2 * n_sections + 1 - min(zeros_at_origin, poles_at_origin))


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Per-section steady-state initial conditions for a unit step
    (scipy.signal.sosfilt_zi semantics, transposed direct form II)."""
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    zi = np.zeros((n_sections, 2))
    scale = 1.0
    for k in range(n_sections):
        b = sos[k, :3]
        a = sos[k, 3:]
        # state map: z = M z + v * x
        M = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        v = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
        z_star = np.linalg.solve(np.eye(2) - M, v)
        zi[k] = scale * z_star
        scale *= b.sum() / a.sum()
    return zi


# --------------------------------------------------------------------------
# Device IIR: one SOS section as an associative scan
# --------------------------------------------------------------------------

def _sos_section_scan(x: jax.Array, b: jax.Array, a: jax.Array,
                      zi: jax.Array) -> jax.Array:
    """Apply one second-order section along the last axis of x (batch, L).

    zi: (batch, 2) initial state.
    """
    b0, b1, b2 = b[0], b[1], b[2]
    a1, a2 = a[1], a[2]
    M = jnp.array([[-a1, 1.0], [-a2, 0.0]], dtype=x.dtype)
    v = jnp.array([b1 - a1 * b0, b2 - a2 * b0], dtype=x.dtype)

    # affine elements: (A[n], c[n]) with z[n] = A z[n-1] + c
    L = x.shape[-1]
    A = jnp.broadcast_to(M, (L, 2, 2))
    c = x[..., :, None] * v  # (batch, L, 2)
    batch_shape = x.shape[:-1]
    A = jnp.broadcast_to(A, batch_shape + (L, 2, 2))

    # float32 products must not drop to TF32 on a GPU
    hi = jax.lax.Precision.HIGHEST

    def combine(left, right):
        A1, c1 = left
        A2, c2 = right
        return (
            jnp.einsum("...ij,...jk->...ik", A2, A1, precision=hi),
            jnp.einsum("...ij,...j->...i", A2, c1, precision=hi) + c2,
        )

    # fold zi into the first element: z[0] = M zi + v x[0]
    c = c.at[..., 0, :].add(jnp.einsum("ij,...j->...i", M, zi, precision=hi))
    A_scan, c_scan = jax.lax.associative_scan(combine, (A, c), axis=len(batch_shape))
    # z[n] available for all n; y[n] = b0 x[n] + z1[n-1]
    z1_prev = jnp.concatenate(
        [zi[..., :1], c_scan[..., :-1, 0]], axis=-1
    )
    return b0 * x + z1_prev


def _sosfilt_device(x: jax.Array, sos: jax.Array, zi_scaled: jax.Array) -> jax.Array:
    """Cascade of SOS sections; zi_scaled: (n_sections, batch, 2)."""
    n_sections = sos.shape[0]
    out = x
    for k in range(n_sections):
        out = _sos_section_scan(out, sos[k, :3], sos[k, 3:], zi_scaled[k])
    return out


@partial(jax.jit, static_argnames=("padlen",))
def _sosfiltfilt_device_core(
    x: jax.Array, sos: jax.Array, zi_unit: jax.Array, padlen: int
) -> jax.Array:
    """Zero-phase filtering with odd-reflection padding (scipy contract).

    The pipeline is linear and a constant c has the exact closed-form
    response c * H(1)^2 (zi puts each section in steady state immediately),
    so the per-wave mean is removed before the float32 scan and its exact DC
    response added back — this keeps f32 rounding error proportional to the
    AC signal, not the (large) ADC baseline offset.
    """
    mean = jnp.mean(x, axis=-1, keepdims=True)
    dc_gain = jnp.prod(jnp.sum(sos[:, :3], axis=1) / jnp.sum(sos[:, 3:], axis=1))
    dc_response = mean * (dc_gain * dc_gain)
    x = x - mean

    # odd extension: 2*x[0] - x[padlen:0:-1] ... x ... 2*x[-1] - x[-2:-padlen-2:-1]
    left = 2.0 * x[..., :1] - x[..., padlen:0:-1]
    right = 2.0 * x[..., -1:] - x[..., -2 : -padlen - 2 : -1]
    ext = jnp.concatenate([left, x, right], axis=-1)

    # forward: per-section zi = zi_unit[k] * first padded sample
    first = ext[..., 0]  # (batch,)
    zi_f = zi_unit[:, None, :] * first[None, :, None]  # (sections, batch, 2)
    y = _sosfilt_device(ext, sos, zi_f)

    # backward on reversed signal
    y_rev = y[..., ::-1]
    first_b = y_rev[..., 0]
    zi_b = zi_unit[:, None, :] * first_b[None, :, None]
    y2 = _sosfilt_device(y_rev, sos, zi_b)
    y2 = y2[..., ::-1]
    return y2[..., padlen : y2.shape[-1] - padlen] + dc_response


def sosfiltfilt_device(
    waves: Any, sos: np.ndarray, dtype: Any = np.float32,
    backend: str = "auto",
) -> np.ndarray:
    """Zero-phase Butterworth on device; waves (n, L) -> filtered (n, L).

    Waves with L <= padlen are returned unfiltered (reference padlen guard,
    filtering.py:219-224). ``backend`` ("auto" | "xla" | "scan") picks the
    formulation through ops/dispatch.py.
    """
    waves = np.asarray(waves, dtype=np.float32)
    squeeze = waves.ndim == 1
    if squeeze:
        waves = waves[None, :]
    padlen = sosfiltfilt_padlen(sos)
    if waves.shape[-1] <= padlen:
        out = waves.astype(dtype, copy=True)
        return out[0] if squeeze else out

    # the GPU runs the sequential cascade (ops/scan_kernels.py): O(L) work
    # with biquad state in registers, against the associative scan's
    # O(L log L) work over (n, L, 2, 2) affine maps
    if kernel_for("sosfiltfilt", backend) == "scan":
        from waveformanalysis_tpu.ops.scan_kernels import sosfiltfilt_scan

        out = np.asarray(sosfiltfilt_scan(waves, sos), dtype=dtype)
        return out[0] if squeeze else out

    zi = sosfilt_zi(sos)
    out = _sosfiltfilt_device_core(
        jnp.asarray(waves, dtype=jnp.float32),
        jnp.asarray(sos, dtype=jnp.float32),
        jnp.asarray(zi, dtype=jnp.float32),
        padlen,
    )
    out = np.asarray(out, dtype=dtype)
    return out[0] if squeeze else out


def sosfiltfilt_scipy(waves: Any, sos: np.ndarray, dtype: Any = np.float32) -> np.ndarray:
    """Host reference path (bit-exact vs the reference implementation)."""
    from scipy.signal import sosfiltfilt

    waves = np.asarray(waves, dtype=np.float32)
    padlen = sosfiltfilt_padlen(sos)
    if waves.shape[-1] <= padlen:
        return np.array(waves, dtype=dtype, copy=True)
    return np.asarray(sosfiltfilt(sos, waves, axis=-1), dtype=dtype)


# --------------------------------------------------------------------------
# Savitzky-Golay
# --------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _savgol_matrices(window: int, polyorder: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fir_coeffs, left_edge_matrix, right_edge_matrix) for mode='interp'.

    Edge matrices map the first/last ``window`` samples to the halfwin fitted
    edge values (pure linear algebra — exact parity with scipy's polyfit
    edge handling).
    """
    halflen = window // 2
    pos = np.arange(-halflen, window - halflen, dtype=np.float64)
    # FIR coefficients: projection of delta onto poly basis evaluated at 0
    V = np.vander(pos, polyorder + 1, increasing=True)  # (window, p+1)
    pinv = np.linalg.pinv(V)  # (p+1, window)
    fir = pinv[0]  # evaluate fitted poly at x=0
    # edge fit: t = 0..window-1 sample positions
    t = np.arange(window, dtype=np.float64)
    Vt = np.vander(t, polyorder + 1, increasing=True)
    pinv_t = np.linalg.pinv(Vt)  # (p+1, window)
    # left edge: evaluate at t = 0..halflen-1 ; right edge at the mirror
    eval_left = np.vander(t[:halflen], polyorder + 1, increasing=True)
    E_left = eval_left @ pinv_t  # (halflen, window)
    eval_right = np.vander(t[window - halflen :], polyorder + 1, increasing=True)
    E_right = eval_right @ pinv_t
    return fir[::-1].copy(), E_left, E_right


@partial(jax.jit, static_argnames=("window", "polyorder"))
def _savgol_device_core(
    waves: jax.Array, window: int, polyorder: int
) -> jax.Array:
    fir, E_left, E_right = _savgol_matrices(window, polyorder)
    halflen = window // 2
    # float32 convolution and products must not drop to TF32 on a GPU
    hi = jax.lax.Precision.HIGHEST
    # interior: 1-D correlation via conv_general_dilated (batch, 1, L)
    x = waves[:, None, :]
    k = jnp.asarray(fir, dtype=waves.dtype)[None, None, :]
    interior = jax.lax.conv_general_dilated(
        x, k, window_strides=(1,), padding="VALID", precision=hi,
    )[:, 0, :]  # (n, L - window + 1): value at positions halflen..L-halflen-1
    left = jnp.matmul(waves[:, :window],
                      jnp.asarray(E_left, dtype=waves.dtype).T, precision=hi)
    right = jnp.matmul(waves[:, -window:],
                       jnp.asarray(E_right, dtype=waves.dtype).T,
                       precision=hi)
    return jnp.concatenate([left, interior, right], axis=-1)


def savgol_device(
    waves: Any, window: int, polyorder: int, dtype: Any = np.float32
) -> np.ndarray:
    """Savitzky-Golay smoothing (mode='interp' parity) on device."""
    waves = np.asarray(waves, dtype=np.float32)
    squeeze = waves.ndim == 1
    if squeeze:
        waves = waves[None, :]
    n, L = waves.shape
    window = min(int(window), L)
    if window % 2 == 0:
        window -= 1
    if window <= polyorder:
        out = waves.astype(dtype, copy=True)
        return out[0] if squeeze else out
    out = np.asarray(
        _savgol_device_core(jnp.asarray(waves), window, int(polyorder)),
        dtype=dtype,
    )
    return out[0] if squeeze else out


def savgol_scipy(waves: Any, window: int, polyorder: int, dtype: Any = np.float32) -> np.ndarray:
    from scipy.signal import savgol_filter

    waves = np.asarray(waves, dtype=np.float32)
    L = waves.shape[-1]
    window = min(int(window), L)
    if window % 2 == 0:
        window -= 1
    if window <= polyorder:
        return np.array(waves, dtype=dtype, copy=True)
    return np.asarray(
        savgol_filter(waves, window_length=window, polyorder=int(polyorder),
                      axis=-1, mode="interp"),
        dtype=dtype,
    )


# --------------------------------------------------------------------------
# Batch entry points
# --------------------------------------------------------------------------

def apply_filter(
    waves: Any,
    filter_type: str,
    bw_sos: Optional[np.ndarray] = None,
    sg_window_size: Optional[int] = None,
    sg_poly_order: Optional[int] = None,
    engine: str = "device",
    backend: str = "auto",
) -> np.ndarray:
    """Apply a configured filter to a (n, L) batch; returns float32.

    ``backend`` picks the device Butterworth formulation (see
    ``sosfiltfilt_device``); Savitzky-Golay and the scipy engine ignore it."""
    if filter_type == "BW":
        if bw_sos is None:
            raise ValueError("BW filter requires SOS coefficients")
        if engine == "device":
            return sosfiltfilt_device(waves, bw_sos, backend=backend)
        return sosfiltfilt_scipy(waves, bw_sos)
    if filter_type == "SG":
        if sg_window_size is None or sg_poly_order is None:
            raise ValueError("SG filter requires sg_window_size and sg_poly_order")
        fn = savgol_device if engine == "device" else savgol_scipy
        return fn(waves, sg_window_size, sg_poly_order)
    raise ValueError(f"Unsupported filter type: {filter_type!r}; use 'BW' or 'SG'.")


def filter_pool(
    view: Any,
    filter_type: str = "butterworth",
    filter_config: Optional[Dict[str, Any]] = None,
    sampling_rate_hz: float = 500e6,
    engine: str = "device",
) -> np.ndarray:
    """Filter an entire wave_pool through a RecordsView (per-record lengths
    honored); returns a float32 pool with identical offsets."""
    cfg = dict(filter_config or {})
    if filter_type in ("butterworth", "BW"):
        # GHz convention (only frequency ratios matter to the design)
        fs_ghz = float(cfg.get("fs", sampling_rate_hz / 1e9))
        sos = design_butterworth_sos(
            order=int(cfg.get("filter_order", 4)),
            lowcut=float(cfg.get("lowcut", 0.1 * fs_ghz)),
            highcut=float(cfg.get("highcut", 0.4 * fs_ghz)),
            fs=fs_ghz,
        )
        run = lambda w: apply_filter(w, "BW", bw_sos=sos, engine=engine)
    elif filter_type in ("savgol", "SG"):
        window = int(cfg.get("sg_window_size", 11))
        poly = int(cfg.get("sg_poly_order", 3))
        run = lambda w: apply_filter(
            w, "SG", sg_window_size=window, sg_poly_order=poly, engine=engine
        )
    else:
        raise ValueError(f"Unsupported filter type: {filter_type!r}")

    # Filtering must see each record at its TRUE length (padding would
    # pollute edge samples), so batch per unique event_length.
    offsets = np.asarray(view.records["wave_offset"], dtype=np.int64)
    lengths = np.asarray(view.records["event_length"], dtype=np.int64)
    total = int(lengths.sum())
    out = np.zeros(max(total, len(view.wave_pool)), dtype=np.float32)
    for L in np.unique(lengths):
        if L <= 0:
            continue
        rows = np.flatnonzero(lengths == L)
        idx = offsets[rows][:, None] + np.arange(L)[None, :]
        group = view.wave_pool[idx].astype(np.float32)
        filtered = run(group)
        out[idx.reshape(-1)] = filtered.reshape(-1)
    return out
