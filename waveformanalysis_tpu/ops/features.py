"""Basic waveform feature kernels (height / amp / area / max_abs_diff).

Device replacement for the reference per-event Python loops
(reference: waveform_analysis/core/plugins/builtin/cpu/basic_features.py:
89-278). Numeric contract (matched exactly):

- height = baseline - min(wave[height_range])   (negative polarity)
         = max(wave[height_range]) - baseline   (positive polarity)
- amp    = max(wave[height_range]) - min(wave[height_range])
- area   = sum(baseline - wave[area_range]) in float64 (sign per polarity)
- max_abs_diff = max(|diff(wave)|) over the true event length

Design: the device kernel performs only *integer* reductions over the padded
(n_events, wave_len) int16 matrix — min/max/sum/count per window — which are
exact; the tiny final combine (baseline arithmetic) runs vectorized on host
in float64, giving bit-identical results to the reference NumPy pipeline
before the final float32 cast. One pass over the wave matrix; XLA fuses all
window reductions into a single HBM sweep.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

_BIG = np.int32(2**30)
_BIG_F = np.float32(3.0e38)

# bump when reduction semantics change: folded into plugin lineage
KERNEL_VERSION = "features-v2"  # v2: float sources reduce in f32 (no int floor)


@partial(
    jax.jit,
    static_argnames=("height_start", "height_end", "area_start", "area_end"),
)
def feature_reductions(
    waves: jax.Array,
    event_length: jax.Array,
    height_start: int = 0,
    height_end: Optional[int] = None,
    area_start: int = 0,
    area_end: Optional[int] = None,
) -> Dict[str, jax.Array]:
    """Exact integer window reductions over a padded wave matrix.

    Args:
        waves: (n, L) integer ADC samples (padding beyond event_length ignored).
        event_length: (n,) true sample count per event.
        height_start/height_end: sample window for min/max (end=None -> L).
        area_start/area_end: sample window for the sum (end=None -> L).

    Returns dict of (n,) arrays: min_h, max_h (int32, saturated at +/-2^30
    when the window is empty), count_h, sum_a (int64), count_a,
    max_abs_diff (int32).
    """
    n, L = waves.shape
    # integer sources keep the exact-int32 reduction contract; FLOAT
    # sources (the filtered wave / filtered pool under use_filtered) must
    # NOT be floored to ints — reduce in f32, matching the reference's
    # numpy reductions over the float32 filtered wave
    is_float = jnp.issubdtype(waves.dtype, jnp.floating)
    w = waves.astype(jnp.float32 if is_float else jnp.int32)
    big = _BIG_F if is_float else _BIG
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, L), dimension=1)
    valid = idx < event_length[:, None]

    h_end = L if height_end is None else height_end
    a_end = L if area_end is None else area_end

    hmask = valid & (idx >= height_start) & (idx < h_end)
    amask = valid & (idx >= area_start) & (idx < a_end)

    min_h = jnp.min(jnp.where(hmask, w, big), axis=1)
    max_h = jnp.max(jnp.where(hmask, w, -big), axis=1)
    count_h = jnp.sum(hmask, axis=1, dtype=jnp.int32)

    # int32 is exact while L * 32768 < 2^31, i.e. wave_len < 65536 — enforced
    # by callers; keeps the reduction in 32-bit. Float sources accumulate in
    # f32 (documented rtol-1e-5 class).
    sum_a = jnp.sum(jnp.where(amask, w, jnp.zeros((), w.dtype)), axis=1,
                    dtype=jnp.float32 if is_float else jnp.int32)
    count_a = jnp.sum(amask, axis=1, dtype=jnp.int32)

    diff = w[:, 1:] - w[:, :-1]
    dvalid = (idx[:, 1:] < event_length[:, None])  # sample i+1 inside event
    max_abs_diff = jnp.max(
        jnp.where(dvalid, jnp.abs(diff), 0), axis=1
    ) if L > 1 else jnp.zeros((n,), jnp.int32)

    return {
        "min_h": min_h,
        "max_h": max_h,
        "count_h": count_h,
        "sum_a": sum_a,
        "count_a": count_a,
        "max_abs_diff": max_abs_diff,
    }


def combine_features(
    red: Dict[str, np.ndarray],
    baselines: np.ndarray,
    polarity_codes: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Host-side float64 combine of integer reductions into final features.

    polarity_codes: int8, +1 positive / -1 negative / 0 unknown (unknown is
    treated as negative, matching the reference fallback).
    """
    baselines = np.asarray(baselines, dtype=np.float64)
    min_h = np.asarray(red["min_h"], dtype=np.float64)
    max_h = np.asarray(red["max_h"], dtype=np.float64)
    count_h = np.asarray(red["count_h"])
    sum_a = np.asarray(red["sum_a"], dtype=np.float64)
    count_a = np.asarray(red["count_a"], dtype=np.float64)
    positive = np.asarray(polarity_codes) > 0

    has_h = count_h > 0
    height = np.where(positive, max_h - baselines, baselines - min_h)
    height = np.where(has_h, height, 0.0)
    amp = np.where(has_h, max_h - min_h, 0.0)

    has_a = count_a > 0
    area = np.where(
        positive,
        sum_a - count_a * baselines,
        count_a * baselines - sum_a,
    )
    area = np.where(has_a, area, 0.0)

    return {
        "height": height.astype(np.float32),
        "amp": amp.astype(np.float32),
        "area": area.astype(np.float32),
        "max_abs_diff": np.asarray(red["max_abs_diff"], dtype=np.float32),
    }


@partial(
    jax.jit,
    static_argnames=("height_start", "height_end", "area_start", "area_end"),
)
def basic_features_device(
    waves: jax.Array,
    event_length: jax.Array,
    baselines: jax.Array,
    polarity_codes: jax.Array,
    height_start: int = 0,
    height_end: Optional[int] = None,
    area_start: int = 0,
    area_end: Optional[int] = None,
) -> Dict[str, jax.Array]:
    """Fully-on-device variant (float32 combine) for jit/pipeline fusion.

    Used inside larger jitted pipelines where a host round-trip would break
    fusion; float32 area may differ from the reference by ~1e-2 ADC units on
    long integrations (documented tolerance).
    """
    red = feature_reductions(
        waves, event_length,
        height_start=height_start, height_end=height_end,
        area_start=area_start, area_end=area_end,
    )
    b = baselines.astype(jnp.float32)
    positive = polarity_codes > 0
    has_h = red["count_h"] > 0
    min_h = red["min_h"].astype(jnp.float32)
    max_h = red["max_h"].astype(jnp.float32)
    height = jnp.where(positive, max_h - b, b - min_h)
    height = jnp.where(has_h, height, 0.0)
    amp = jnp.where(has_h, max_h - min_h, 0.0)
    count_a = red["count_a"].astype(jnp.float32)
    sum_a = red["sum_a"].astype(jnp.float32)
    has_a = red["count_a"] > 0
    area = jnp.where(positive, sum_a - count_a * b, count_a * b - sum_a)
    area = jnp.where(has_a, area, 0.0)
    return {
        "height": height,
        "amp": amp,
        "area": area,
        "max_abs_diff": red["max_abs_diff"].astype(jnp.float32),
    }


def basic_features_from_waves(
    waves: Any,
    event_length: Any,
    baselines: Any,
    polarity_codes: Any,
    height_range: Tuple[int, Optional[int]] = (0, None),
    area_range: Tuple[int, Optional[int]] = (0, None),
    host_combine: bool = True,
) -> Dict[str, np.ndarray]:
    """End-to-end convenience: device reductions + (default) exact host combine."""
    waves_np = np.ascontiguousarray(waves)
    if waves_np.shape[1] >= 65536:
        raise ValueError(
            f"wave length {waves_np.shape[1]} >= 65536 would overflow the "
            "exact int32 area accumulator"
        )
    waves_d = jnp.asarray(waves_np)
    el = jnp.asarray(np.asarray(event_length, dtype=np.int32))
    hs, he = int(height_range[0]), height_range[1]
    as_, ae = int(area_range[0]), area_range[1]
    he = None if he is None else int(he)
    ae = None if ae is None else int(ae)
    # negative-index windows follow python slicing on the padded length
    L = waves_d.shape[1]
    hs, he2 = _norm_window(hs, he, L)
    as2, ae2 = _norm_window(as_, ae, L)
    if host_combine:
        red = feature_reductions(
            waves_d, el, height_start=hs, height_end=he2,
            area_start=as2, area_end=ae2,
        )
        red = jax.device_get(red)  # one transfer op for the whole dict
        return combine_features(red, baselines, polarity_codes)
    out = basic_features_device(
        waves_d, el, jnp.asarray(np.asarray(baselines)),
        jnp.asarray(np.asarray(polarity_codes)),
        height_start=hs, height_end=he2, area_start=as2, area_end=ae2,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _norm_window(start: int, end: Optional[int], L: int) -> Tuple[int, Optional[int]]:
    """Normalize a python-slice-style window against padded length L."""
    s, e, _ = slice(start, end).indices(L)
    return int(s), int(e)


def compute_baselines(
    waves: Any,
    window: Tuple[int, int] = (0, 20),
    event_length: Optional[Any] = None,
) -> np.ndarray:
    """Baseline = mean of the baseline window, float64-exact.

    (reference analog: WaveformStruct baseline window mean,
    waveforms.py:644-799). Integer sums are computed on device; the division
    happens on host in float64 for exact parity.
    """
    waves_d = jnp.asarray(np.ascontiguousarray(waves))
    n, L = waves_d.shape
    if event_length is None:
        el = jnp.full((n,), L, dtype=jnp.int32)
    else:
        el = jnp.asarray(np.asarray(event_length, dtype=np.int32))
    s, e = _norm_window(int(window[0]), int(window[1]), L)
    red = feature_reductions(waves_d, el, area_start=s, area_end=e)
    sums = np.asarray(red["sum_a"], dtype=np.float64)
    counts = np.asarray(red["count_a"], dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = sums / counts
    return np.where(counts > 0, out, 0.0)
