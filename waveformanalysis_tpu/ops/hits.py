"""Threshold-crossing hit detection kernel.

Device replacement for the reference vectorized threshold hit builder
(reference: waveform_analysis/core/plugins/builtin/cpu/hit_finder.py:329-415
and the padded mask-diff primitive event_grouping.py:47-95). Contract:

- signal >= per-event threshold marks samples; contiguous runs form hits;
- each run extends by left/right extensions, clipped to the padded window;
- per hit: position = argmax of the extended segment, height = that max,
  integral = sum(max(segment, 0)), rise = (pos-start)*dt ns,
  fall = (end-1-pos)*dt ns, edges clipped to the record length;
- global timestamp = event timestamp + position * dt * 1000 (ps).

Runs compact into a fixed (n, K) capacity like the peak kernel; overflow is
counted per event.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp

from waveformanalysis_tpu.ops.peaks import compact_first_k

KERNEL_VERSION = "hits-v1"
DEFAULT_MAX_HITS = 32


@partial(
    jax.jit,
    static_argnames=("max_hits", "left_extension", "right_extension"),
)
def threshold_hits_batch(
    signal: jax.Array,
    thresholds: jax.Array,
    valid_length: jax.Array,
    left_extension: int = 2,
    right_extension: int = 2,
    max_hits: int = DEFAULT_MAX_HITS,
) -> Dict[str, jax.Array]:
    """Find threshold runs over a (n, L) signal batch.

    Returns (n, K) arrays: valid, position, height, integral, seg_start,
    seg_end, run_start, run_end; plus (n,) n_runs.
    """
    x = signal.astype(jnp.float32)
    n, L = x.shape
    K = max_hits
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)
    in_range = pos < valid_length[:, None]

    mask = (x >= thresholds[:, None]) & in_range

    prev = jnp.concatenate([jnp.zeros((n, 1), bool), mask[:, :-1]], axis=1)
    nxt = jnp.concatenate([mask[:, 1:], jnp.zeros((n, 1), bool)], axis=1)
    is_start = mask & ~prev
    is_end = mask & ~nxt  # inclusive last sample of the run

    n_runs = jnp.sum(is_start, axis=1, dtype=jnp.int32)

    # compact starts/ends by position into (n, K) — sort-free
    pos_b = jnp.broadcast_to(pos, (n, L))
    (starts,), s_ok = compact_first_k(is_start, (pos_b,), K, (0,))
    (ends_incl,), e_ok = compact_first_k(is_end, (pos_b,), K, (0,))
    run_valid = s_ok & e_ok
    ends = ends_incl + 1  # exclusive

    seg_start = jnp.maximum(starts - left_extension, 0)
    seg_end = jnp.minimum(ends + right_extension, L)

    heights = jnp.zeros((n, K), jnp.float32)
    integrals = jnp.zeros((n, K), jnp.float32)
    positions = jnp.zeros((n, K), jnp.int32)

    def body(carry):
        k, h, integ, p = carry
        s = seg_start[:, k][:, None]
        e = seg_end[:, k][:, None]
        m = (pos >= s) & (pos < e)
        seg_vals = jnp.where(m, x, -jnp.inf)
        mx = jnp.max(seg_vals, axis=1)
        # argmax within the segment (first occurrence, matching np.argmax)
        am = jnp.argmax(seg_vals, axis=1).astype(jnp.int32)
        pos_sum = jnp.sum(jnp.where(m, jnp.maximum(x, 0.0), 0.0), axis=1)
        ok = run_valid[:, k]
        return (
            k + 1,
            h.at[:, k].set(jnp.where(ok, mx, 0.0)),
            integ.at[:, k].set(jnp.where(ok, pos_sum, 0.0)),
            p.at[:, k].set(jnp.where(ok, am, 0)),
        )

    # loop only to the batch-max run count — typical waveforms have 1-2 runs
    kmax = jnp.minimum(K, jnp.max(n_runs))
    _, heights, integrals, positions = jax.lax.while_loop(
        lambda c: c[0] < kmax, body,
        (jnp.int32(0), heights, integrals, positions),
    )

    return {
        "valid": run_valid,
        "position": positions,
        "height": heights,
        "integral": integrals,
        "seg_start": seg_start,
        "seg_end": seg_end,
        "run_start": starts,
        "run_end": ends,
        "n_runs": n_runs,
    }


def compact_threshold_hits(
    results: Dict[str, np.ndarray],
    timestamps: np.ndarray,
    boards: np.ndarray,
    channels: np.ndarray,
    record_ids: np.ndarray,
    dt_ns: np.ndarray,
    record_lengths: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Flatten (n, K) run results into flat THRESHOLD_HIT columns (host)."""
    valid = np.asarray(results["valid"])
    rows, cols = np.nonzero(valid)
    return threshold_columns_from_flat(
        rows=rows,
        position=np.asarray(results["position"])[rows, cols],
        height=np.asarray(results["height"])[rows, cols],
        integral=np.asarray(results["integral"])[rows, cols],
        seg_start=np.asarray(results["seg_start"])[rows, cols],
        seg_end=np.asarray(results["seg_end"])[rows, cols],
        run_start=np.asarray(results["run_start"])[rows, cols],
        run_end=np.asarray(results["run_end"])[rows, cols],
        timestamps=timestamps, boards=boards, channels=channels,
        record_ids=record_ids, dt_ns=dt_ns, record_lengths=record_lengths,
    )


def threshold_columns_from_flat(
    rows: np.ndarray,
    position: np.ndarray,
    height: np.ndarray,
    integral: np.ndarray,
    seg_start: np.ndarray,
    seg_end: np.ndarray,
    run_start: np.ndarray,
    run_end: np.ndarray,
    timestamps: np.ndarray,
    boards: np.ndarray,
    channels: np.ndarray,
    record_ids: np.ndarray,
    dt_ns: np.ndarray,
    record_lengths: np.ndarray,
) -> Dict[str, np.ndarray]:
    """THRESHOLD_HIT columns from already-compacted per-run slot values.

    ``rows`` maps each run to its source waveform (row-major slot order —
    the order ``np.nonzero(valid)`` produces). Shared by the host compaction
    above and the device-compacted fused-bundle transfer path.
    """
    pos = np.asarray(position).astype(np.int64)
    start = np.asarray(run_start).astype(np.int64)
    end = np.asarray(run_end).astype(np.int64)
    seg_s = np.asarray(seg_start).astype(np.int64)
    seg_e = np.asarray(seg_end).astype(np.int64)
    dt = np.asarray(dt_ns, dtype=np.int64)[rows]
    rec_len = np.asarray(record_lengths, dtype=np.int64)[rows]

    edge_start = np.clip(seg_s, 0, rec_len)
    edge_end = np.maximum(np.clip(seg_e, 0, rec_len), edge_start)

    return {
        "position": pos,
        "height": np.asarray(height).astype(np.float32),
        "integral": np.asarray(integral).astype(np.float32),
        "edge_start": edge_start.astype(np.int32),
        "edge_end": edge_end.astype(np.int32),
        "width": (edge_end - edge_start).astype(np.float32),
        "dt": dt.astype(np.int32),
        "rise_time": (np.maximum(pos - start, 0) * dt).astype(np.float32),
        "fall_time": (np.maximum((end - 1) - pos, 0) * dt).astype(np.float32),
        "timestamp": np.asarray(timestamps, dtype=np.int64)[rows] + pos * dt * 1000,
        "board": np.asarray(boards, dtype=np.int16)[rows],
        "channel": np.asarray(channels, dtype=np.int16)[rows],
        "record_id": np.asarray(record_ids, dtype=np.int64)[rows],
    }


def find_hit_runs(mask: np.ndarray) -> tuple:
    """Host primitive: (rows, starts, ends_exclusive) of contiguous True runs
    per row (reference analog: event_grouping.py find_hits)."""
    mask = np.asarray(mask, dtype=bool)
    padded = np.pad(mask, ((0, 0), (1, 1)))
    d = np.diff(padded.astype(np.int8), axis=1)
    rows_s, starts = np.where(d == 1)
    rows_e, ends = np.where(d == -1)
    return rows_s, starts, ends
