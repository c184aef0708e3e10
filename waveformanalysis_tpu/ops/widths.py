"""Waveform width kernels: threshold-crossing rise/fall and integral quantiles.

Device replacement for the reference per-hit Python loops
(reference: waveform_analysis/core/plugins/builtin/cpu/waveform_width.py:
153-380 and waveform_width_integral.py:160-230). Contracts:

- rise/fall: baseline = mean of the first 50 samples; corrected = wave -
  baseline; thresholds are fractions of the corrected peak value; rising
  crossing = first sample in [0, peak) with corrected >= thr; falling = first
  sample in [peak, L) with corrected <= thr; optional linear interpolation;
  hits whose corrected peak value <= 0 are skipped (reference behavior —
  widths assume positive-going pulses).
- integral quantile: x = max(signal, 0); t_q = searchsorted(cumsum(x),
  q * total, side='left').

Both kernels are one row per hit/event — fully vectorized, no inner loops.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple


import jax
import jax.numpy as jnp

KERNEL_VERSION = "widths-v1"

_BASELINE_SAMPLES = 50


def _width_for_positions(
    corr: jax.Array,
    p: jax.Array,
    rise_low: float,
    rise_high: float,
    fall_high: float,
    fall_low: float,
    interpolation: bool,
) -> Dict[str, jax.Array]:
    """Crossing widths for one peak position per row of ``corr``.

    Shared core of :func:`width_from_peaks` (gathered per-hit rows) and
    :func:`width_from_peak_slots` (fixed-capacity slot tables): both paths
    run EXACTLY these ops per (row, position), so outputs are bit-identical.
    """
    h, L = corr.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)
    p = p.astype(jnp.int32)

    p_safe = jnp.clip(p, 0, L - 1)
    peak_value = jnp.take_along_axis(corr, p_safe[:, None], axis=1)[:, 0]
    valid = (p >= 0) & (p < L) & (peak_value > 0)

    def crossing_rising(thr: jax.Array) -> Tuple[jax.Array, jax.Array]:
        # first index in [0, p) with corr >= thr
        m = (corr >= thr[:, None]) & (pos < p[:, None])
        idx = jnp.min(jnp.where(m, pos, L), axis=1)
        found = idx < L
        if interpolation:
            i_safe = jnp.clip(idx, 1, L - 1)
            y0 = jnp.take_along_axis(corr, (i_safe - 1)[:, None], axis=1)[:, 0]
            y1 = jnp.take_along_axis(corr, i_safe[:, None], axis=1)[:, 0]
            denom = y1 - y0
            frac = jnp.where(jnp.abs(denom) < 1e-10, 0.0, (thr - y0) / jnp.where(
                jnp.abs(denom) < 1e-10, 1.0, denom))
            interp = (i_safe - 1).astype(jnp.float32) + frac
            out = jnp.where((idx > 0) & (jnp.abs(denom) >= 1e-10),
                            interp, idx.astype(jnp.float32))
        else:
            out = idx.astype(jnp.float32)
        return out, found

    def crossing_falling(thr: jax.Array) -> Tuple[jax.Array, jax.Array]:
        # first index in [p, L) with corr <= thr (relative index from p)
        m = (corr <= thr[:, None]) & (pos >= p[:, None])
        idx = jnp.min(jnp.where(m, pos, L), axis=1)
        found = idx < L
        rel = idx - p
        if interpolation:
            i_safe = jnp.clip(idx, 1, L - 1)
            y0 = jnp.take_along_axis(corr, (i_safe - 1)[:, None], axis=1)[:, 0]
            y1 = jnp.take_along_axis(corr, i_safe[:, None], axis=1)[:, 0]
            denom = y1 - y0
            frac = jnp.where(jnp.abs(denom) < 1e-10, 0.0, (thr - y0) / jnp.where(
                jnp.abs(denom) < 1e-10, 1.0, denom))
            interp = (i_safe - 1).astype(jnp.float32) + frac
            # relative index 0 (crossing at the peak itself) never interpolates
            out = jnp.where((rel > 0) & (jnp.abs(denom) >= 1e-10),
                            interp, idx.astype(jnp.float32))
        else:
            out = idx.astype(jnp.float32)
        return out, found

    r_low, r_low_ok = crossing_rising(peak_value * rise_low)
    r_high, r_high_ok = crossing_rising(peak_value * rise_high)
    f_high, f_high_ok = crossing_falling(peak_value * fall_high)
    f_low, f_low_ok = crossing_falling(peak_value * fall_low)

    rise_ok = r_low_ok & r_high_ok
    fall_ok = f_high_ok & f_low_ok
    rise_samples = jnp.where(rise_ok, r_high - r_low, 0.0)
    fall_samples = jnp.where(fall_ok, f_low - f_high, 0.0)
    total_ok = r_low_ok & f_low_ok
    total_samples = jnp.where(total_ok, f_low - r_low, 0.0)

    return {
        "rise_samples": rise_samples,
        "fall_samples": fall_samples,
        "total_samples": total_samples,
        "peak_height": peak_value,
        "valid": valid,
    }


@partial(jax.jit, static_argnames=("interpolation",))
def width_from_peaks(
    waves: jax.Array,
    peak_positions: jax.Array,
    rise_low: float = 0.1,
    rise_high: float = 0.9,
    fall_high: float = 0.9,
    fall_low: float = 0.1,
    interpolation: bool = True,
) -> Dict[str, jax.Array]:
    """Rise/fall/total widths for one peak per row.

    waves: (h, L) — the waveform each hit points at (already gathered);
    peak_positions: (h,) sample index of the peak within each row.

    Returns (h,) arrays: rise_samples, fall_samples, total_samples,
    peak_height, valid.
    """
    w = waves.astype(jnp.float32)
    h, L = w.shape
    nb = min(_BASELINE_SAMPLES, L)
    baseline = jnp.mean(w[:, :nb], axis=1)
    corr = w - baseline[:, None]
    return _width_for_positions(
        corr, peak_positions, rise_low, rise_high, fall_high, fall_low,
        interpolation,
    )


def width_from_peak_slots(
    waves: jax.Array,
    positions: jax.Array,
    slot_valid: jax.Array,
    rise_low: float = 0.1,
    rise_high: float = 0.9,
    fall_high: float = 0.9,
    fall_low: float = 0.1,
    interpolation: bool = True,
) -> Dict[str, jax.Array]:
    """Widths for FIXED-CAPACITY peak slot tables, inside a fused program.

    waves: (n, L); positions / slot_valid: (n, K) from the peak kernel.
    Returns (n, K) arrays matching :func:`width_from_peaks` per slot, plus
    ``valid`` = the INPUT slot mask (so device compaction aligns width rows
    1:1 with the emitted hit table) and ``width_valid`` = the width kernel's
    own validity (positive corrected peak, in-range position) that the host
    filter applies exactly like the standalone plugin.

    The baseline/corrected signal is computed ONCE per event and shared by
    all K slots — the per-(row, position) arithmetic is `_width_for_positions`
    verbatim, so values are bit-identical to the gathered-row path.
    """
    w = waves.astype(jnp.float32)
    n, L = w.shape
    K = positions.shape[1]
    nb = min(_BASELINE_SAMPLES, L)
    baseline = jnp.mean(w[:, :nb], axis=1)
    corr = w - baseline[:, None]

    outs = []
    for k in range(K):
        outs.append(_width_for_positions(
            corr, positions[:, k], rise_low, rise_high, fall_high, fall_low,
            interpolation,
        ))
    stacked = {
        key: jnp.stack([o[key] for o in outs], axis=1)
        for key in ("rise_samples", "fall_samples", "total_samples",
                    "peak_height")
    }
    stacked["width_valid"] = jnp.stack(
        [o["valid"] for o in outs], axis=1
    ).astype(jnp.int32)
    stacked["valid"] = slot_valid
    stacked["position"] = positions.astype(jnp.int32)
    return stacked


@jax.jit
def integral_quantile_width(
    signal: jax.Array,
    valid_length: jax.Array,
    q_low: float = 0.10,
    q_high: float = 0.90,
) -> Dict[str, jax.Array]:
    """Cumulative-integral quantile width per event.

    signal: (n, L) polarity-normalized (positive-going) baseline-corrected
    signal; padding beyond valid_length must be ignorable (masked here).
    """
    x = jnp.maximum(signal.astype(jnp.float32), 0.0)
    n, L = x.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)
    x = jnp.where(pos < valid_length[:, None], x, 0.0)

    csum = jnp.cumsum(x.astype(jnp.float64) if x.dtype == jnp.float64 else x,
                      axis=1)
    q_total = csum[:, -1]
    ok = (q_total > 0) & jnp.isfinite(q_total)

    # searchsorted(csum, target, 'left') == count of csum < target
    t_low = jnp.sum(csum < (q_low * q_total)[:, None], axis=1)
    t_high = jnp.sum(csum < (q_high * q_total)[:, None], axis=1)

    t_low = jnp.where(ok, t_low, 0).astype(jnp.float32)
    t_high = jnp.where(ok, t_high, 0).astype(jnp.float32)
    width = jnp.maximum(t_high - t_low, 0.0)

    return {
        "t_low_samples": t_low,
        "t_high_samples": t_high,
        "width_samples": jnp.where(ok, width, 0.0),
        "q_total": q_total,
    }
