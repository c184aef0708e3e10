"""Flagship fused pipeline: the full records->features->hits->S1/S2 chain
as ONE jitted device program.

This composes the production kernels (feature reductions, scipy-parity peak
finding, threshold-run detection, 10-90% width crossings, range
classification) that the plugin DAG runs as separate steps — here they fuse
into a single XLA program over a padded (n_events, wave_len) batch so the
wave matrix streams from HBM once per kernel family with no host hops.
This is the device answer to the reference's per-plugin NumPy passes
(SURVEY.md §3.1 hot loops) and the benchmark target
(records->features->S1/S2, BASELINE.md).

Multi-chip: :func:`make_sharded_chain` shards the event axis over a
("data",) mesh; label counts and total area psum-reduce across devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from waveformanalysis_tpu.ops.features import feature_reductions
from waveformanalysis_tpu.ops.hits import threshold_hits_batch
from waveformanalysis_tpu.ops.peaks import find_peaks_batch, peak_heights_batch
from waveformanalysis_tpu.ops.widths import width_from_peaks

CHAIN_VERSION = "full-chain-v1"


@dataclass(frozen=True)
class ChainConfig:
    """Static configuration compiled into the chain."""

    height_range: Tuple[int, int] = (40, 90)
    area_start: int = 0
    # peak finding (hit plugin defaults)
    peak_height: float = 30.0
    peak_distance: int = 2
    peak_prominence: float = 0.7
    peak_width: float = 4.0
    use_derivative: bool = True
    max_peaks: int = 8
    # threshold hits
    hit_threshold: float = 10.0
    left_extension: int = 2
    right_extension: int = 2
    max_hits: int = 8
    # widths
    rise_low: float = 0.1
    rise_high: float = 0.9
    # classification (samples)
    s1_width_max: float = 30.0
    s2_width_min: float = 40.0

    def __hash__(self) -> int:
        return hash(tuple(sorted(self.__dict__.items())))


def full_chain_step(
    waves: jax.Array,
    event_length: jax.Array,
    baselines: jax.Array,
    polarity_codes: jax.Array,
    cfg: ChainConfig,
) -> Dict[str, jax.Array]:
    """One fused pass over a padded waveform batch.

    Returns per-event features, fixed-capacity peak/hit tables, per-event
    widths and S1/S2 labels — all device arrays.
    """
    n, L = waves.shape
    w32 = waves.astype(jnp.float32)

    # ---- basic features (exact integer reductions, f32 combine) ----------
    hs, he = cfg.height_range
    red = feature_reductions(
        waves, event_length,
        height_start=hs, height_end=min(he, L),
        area_start=cfg.area_start, area_end=L,
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
    area = jnp.where(positive, sum_a - count_a * b, count_a * b - sum_a)
    area = jnp.where(red["count_a"] > 0, area, 0.0)

    # ---- polarity-normalized signal --------------------------------------
    sign = jnp.where(positive, 1.0, -1.0).astype(jnp.float32)
    signal = sign[:, None] * (w32 - b[:, None])

    # ---- peak finding (hit plugin semantics) ------------------------------
    if cfg.use_derivative:
        det = sign[:, None] * (w32[:, 1:] - w32[:, :-1])
        det_len = jnp.maximum(event_length - 1, 0)
    else:
        det = signal
        det_len = event_length
    peaks = find_peaks_batch(
        det, height=cfg.peak_height, prominence=cfg.peak_prominence,
        width=cfg.peak_width, distance=cfg.peak_distance,
        max_peaks=cfg.max_peaks, valid_length=det_len.astype(jnp.int32),
    )
    peak_heights = peak_heights_batch(
        w32, peaks["left_ips"], peaks["right_ips"], peaks["valid"],
    )

    # ---- threshold hits -----------------------------------------------------
    hits = threshold_hits_batch(
        signal, jnp.full((n,), cfg.hit_threshold, jnp.float32),
        event_length.astype(jnp.int32),
        left_extension=cfg.left_extension,
        right_extension=cfg.right_extension,
        max_hits=cfg.max_hits,
    )

    # ---- widths on the dominant peak per event ------------------------------
    best_k = jnp.argmax(
        jnp.where(peaks["valid"], peak_heights, -jnp.inf), axis=1
    )
    best_pos = jnp.take_along_axis(peaks["position"], best_k[:, None], axis=1)[:, 0]
    has_peak = jnp.any(peaks["valid"], axis=1)
    widths = width_from_peaks(
        signal, jnp.where(has_peak, best_pos, 0),
        rise_low=cfg.rise_low, rise_high=cfg.rise_high,
        fall_high=cfg.rise_high, fall_low=cfg.rise_low,
    )
    width_samples = jnp.where(
        has_peak & widths["valid"], widths["total_samples"], 0.0
    )

    # ---- S1/S2 labels ---------------------------------------------------------
    classified = has_peak & (width_samples > 0)
    label = jnp.where(
        classified & (width_samples <= cfg.s1_width_max), 1,
        jnp.where(classified & (width_samples >= cfg.s2_width_min), 2, 0),
    ).astype(jnp.int8)

    return {
        "height": height,
        "amp": amp,
        "area": area,
        "max_abs_diff": red["max_abs_diff"].astype(jnp.float32),
        "peak_position": jnp.where(has_peak, best_pos, -1).astype(jnp.int32),
        "n_peaks": jnp.sum(peaks["valid"], axis=1).astype(jnp.int32),
        "n_hits": jnp.sum(hits["valid"], axis=1).astype(jnp.int32),
        "hit_integral": jnp.sum(
            jnp.where(hits["valid"], hits["integral"], 0.0), axis=1
        ),
        "rise_samples": jnp.where(has_peak, widths["rise_samples"], 0.0),
        "fall_samples": jnp.where(has_peak, widths["fall_samples"], 0.0),
        "width_samples": width_samples,
        "label": label,
        # overflow contract: events whose candidate peaks / threshold runs
        # exceeded the static max_peaks/max_hits capacity (beyond-K entries
        # are dropped on device; the host wrapper's policy decides whether
        # that warns or raises — see run_chain / test_chain_overflow.py)
        "n_peak_overflow": jnp.sum(
            peaks["n_candidates"] > cfg.max_peaks
        ).astype(jnp.int32),
        "n_hit_overflow": jnp.sum(
            hits["n_runs"] > cfg.max_hits
        ).astype(jnp.int32),
    }


CHAIN_OUT_KEYS = (
    "height", "amp", "area", "max_abs_diff", "peak_position", "n_peaks",
    "n_hits", "hit_integral", "rise_samples", "fall_samples",
    "width_samples", "label",
)
CHAIN_STATS_KEYS = ("n_s1", "n_s2", "total_area")
CHAIN_OVERFLOW_KEYS = ("n_peak_overflow", "n_hit_overflow")


class ChainOverflowError(RuntimeError):
    """Raised in strict mode when events exceed the static peak/hit
    capacity (their beyond-K entries would be silently dropped)."""


def run_chain(
    waves,
    event_length,
    baselines,
    polarity_codes,
    cfg: Optional[ChainConfig] = None,
    overflow_policy: str = "warn",
) -> Dict[str, jax.Array]:
    """Host wrapper around the jitted chain with an explicit overflow policy.

    policy:
      - ``warn`` (default): log a warning with the overflow counts;
      - ``raise``: raise :class:`ChainOverflowError` (strict mode);
      - ``ignore``: counters are still in the outputs, nothing else.

    The counters (`n_peak_overflow`, `n_hit_overflow`) count events whose
    candidate peaks / threshold runs exceeded ``cfg.max_peaks`` /
    ``cfg.max_hits`` — those events keep their K strongest-ordered entries
    and drop the rest (static device shapes; the reference's unbounded
    Python lists have no such cap, peak_finding.py:446).
    """
    if overflow_policy not in ("warn", "raise", "ignore"):
        raise ValueError(f"unknown overflow_policy {overflow_policy!r}")
    step = make_jit_chain(cfg)
    out = step(waves, event_length, baselines, polarity_codes)
    if overflow_policy != "ignore":
        n_po = int(out["n_peak_overflow"])
        n_ho = int(out["n_hit_overflow"])
        if n_po or n_ho:
            cfg = cfg or ChainConfig()
            msg = (
                f"full chain capacity overflow: {n_po} events exceeded "
                f"max_peaks={cfg.max_peaks}, {n_ho} exceeded "
                f"max_hits={cfg.max_hits}; beyond-capacity entries dropped. "
                f"Raise the limits in ChainConfig or use overflow_policy="
                f"'ignore'."
            )
            if overflow_policy == "raise":
                raise ChainOverflowError(msg)
            import logging

            logging.getLogger(__name__).warning(msg)
    return out


def make_jit_chain(cfg: Optional[ChainConfig] = None):
    """Single-device jitted full chain."""
    cfg = cfg or ChainConfig()

    @jax.jit
    def step(waves, event_length, baselines, polarity_codes):
        return full_chain_step(waves, event_length, baselines, polarity_codes, cfg)

    return step


def make_sharded_chain(mesh: Mesh, cfg: Optional[ChainConfig] = None,
                       axis: str = "data"):
    """Full chain sharded over the event axis with psum run statistics."""
    cfg = cfg or ChainConfig()

    def local(waves, event_length, baselines, polarity_codes):
        out = full_chain_step(waves, event_length, baselines, polarity_codes, cfg)
        out["n_s1"] = jax.lax.psum(
            jnp.sum(out["label"] == 1).astype(jnp.int32), axis
        )
        out["n_s2"] = jax.lax.psum(
            jnp.sum(out["label"] == 2).astype(jnp.int32), axis
        )
        out["total_area"] = jax.lax.psum(jnp.sum(out["area"]), axis)
        for k in CHAIN_OVERFLOW_KEYS:
            out[k] = jax.lax.psum(out[k], axis)
        return out

    out_specs = {k: P(axis) for k in CHAIN_OUT_KEYS}
    out_specs.update({k: P() for k in CHAIN_STATS_KEYS + CHAIN_OVERFLOW_KEYS})
    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sharded)


def example_chain_batch(
    n_events: int = 256, wave_length: int = 256, seed: int = 0
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Synthetic mixed S1/S2 batch (positive pulses) for the chain."""
    rng = np.random.default_rng(seed)
    t = np.arange(wave_length)
    c = rng.integers(60, wave_length - 60, size=n_events)[:, None]
    odd = (np.arange(n_events) % 2 == 1)[:, None]
    sigma = np.where(odd, 25.0, 3.0)
    amp = np.where(odd, 250.0, 400.0)
    waves = 1000.0 + amp * np.exp(-((t - c) ** 2) / (2 * sigma**2))
    waves += rng.normal(0, 2, waves.shape)
    waves = np.round(waves).astype(np.int16)
    return (
        jnp.asarray(waves),
        jnp.asarray(np.full(n_events, wave_length, np.int32)),
        jnp.asarray(np.full(n_events, 1000.0, np.float32)),
        jnp.asarray(np.full(n_events, 1, np.int8)),  # positive pulses
    )
