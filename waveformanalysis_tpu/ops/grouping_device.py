"""Device event-grouping kernels: jitted anchor-window clustering and
chained-gap coincidence.

These are the jax rebuilds of the host kernels in
:mod:`waveformanalysis_tpu.ops.grouping`, which remain the parity oracles
(reference behavior: waveform_analysis/core/processing/event_grouping.py:
99-526 — the numba boundary loop at :478).

Design notes
------------
- The anchor-window chain (each cluster = hits within ``window`` of its
  first hit) is inherently sequential in its naive form: the next anchor is
  only known once the previous one is. The reference needed numba for this
  loop. Here it becomes a *binary-lifting* (pointer-doubling) kernel:
  ``nxt[i] = searchsorted(ts, ts[i] + window, 'right')`` is a monotone jump
  function, so jump tables ``J_k = nxt^(2^k)`` are built with log2(n)
  vectorized gathers, and every hit then finds its cluster ordinal with a
  vectorized log2(n)-step descent. Total O(n log n) fully-parallel work, no
  sequential dependence — the XLA-friendly shape of an irreducible chain.
- The chained-gap rule (join while start <= running-max(end) + gap) is a
  cumulative-max plus a prefix-sum — directly vectorizable.
- Timestamps are int64 picoseconds. jax defaults to x64-disabled, so these
  kernels trace under ``jax.experimental.enable_x64`` and keep the *index*
  space in int32 (n always fits); only the timestamp compare/searchsorted
  runs in (emulated) int64. Grouping inputs are tiny next to the waveform
  matrices, so the emulation cost is noise.
- Fractional windows are floored to whole picoseconds first: for integer
  timestamps, ``d > w  <=>  d >= floor(w)+1``, so the integer-window kernel
  is exact for any non-negative float window.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

KERNEL_VERSION = "grouping-device-v1"


# ---------------------------------------------------------------------------
# anchor-window clustering (df_events)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def _anchor_event_ids_impl(ts_sorted: jax.Array, window_ps_int: jax.Array) -> jax.Array:
    """Event id per hit for time-sorted int64 timestamps (trace under x64).

    ``window_ps_int`` is an int64 scalar (already floored).
    """
    n = ts_sorted.shape[0]
    # nxt[i] = first index whose timestamp exceeds ts[i] + window.
    # Strictly > i because ts[i] <= ts[i] + window, so jumps always advance.
    nxt = jnp.searchsorted(
        ts_sorted, ts_sorted + window_ps_int, side="right"
    ).astype(jnp.int32)

    levels = max(1, int(n).bit_length())
    # Sentinel row n is a fixed point so lifted tables stay in range.
    jump = jnp.concatenate([nxt, jnp.array([n], jnp.int32)])
    # Stack J_k = nxt^(2^k) for k = 0..levels-1 via scan (O(1) trace size;
    # each step is one vectorized gather).
    _, tables = jax.lax.scan(
        lambda j, _: (j[j], j), jump, None, length=levels
    )

    idx = jnp.arange(n, dtype=jnp.int32)

    # Descend from the largest stride: count how many anchor jumps from hit 0
    # stay <= i. That count is exactly i's cluster ordinal.
    def descend(step, state):
        pos, cnt = state
        k = levels - 1 - step
        stepped = tables[k][pos]
        take = stepped <= idx
        pos = jnp.where(take, stepped, pos)
        cnt = jnp.where(
            take, cnt + jnp.left_shift(jnp.int32(1), k.astype(jnp.int32)), cnt
        )
        return pos, cnt

    _, cnt = jax.lax.fori_loop(
        0, levels, descend,
        (jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32)),
    )
    return cnt


def anchor_window_event_ids(
    ts_sorted: np.ndarray | jax.Array, window_ps: float
) -> jax.Array:
    """Device event ids for anchor-window clustering.

    Parameters mirror :func:`waveformanalysis_tpu.ops.grouping.
    anchor_window_boundaries`; returns an int32 per-hit event-id array
    (non-decreasing) instead of boundaries. ``event_id[i] = k`` means hit
    ``i`` is in the cluster opened by anchor ``a_k`` (``a_0 = 0``,
    ``a_{k+1} = nxt[a_k]``).
    """
    if window_ps < 0:
        raise ValueError("window_ps must be >= 0")
    n = int(np.shape(ts_sorted)[0])
    if n == 0:
        return jnp.zeros(0, jnp.int32)
    with jax.enable_x64(True):
        ts = jnp.asarray(np.asarray(ts_sorted, dtype=np.int64))
        w = jnp.asarray(int(np.floor(window_ps)), dtype=jnp.int64)
        return _anchor_event_ids_impl(ts, w)


def boundaries_from_event_ids(event_ids: np.ndarray) -> np.ndarray:
    """Host helper: convert a non-decreasing event-id array to boundaries
    compatible with :func:`grouping.anchor_window_boundaries`."""
    event_ids = np.asarray(event_ids)
    n = len(event_ids)
    if n == 0:
        return np.array([0], dtype=np.int64)
    steps = np.flatnonzero(np.diff(event_ids)) + 1
    return np.concatenate([[0], steps, [n]]).astype(np.int64)


# ---------------------------------------------------------------------------
# chained-gap coincidence (hit_grouped)
# ---------------------------------------------------------------------------


@jax.jit
def _chained_gap_ids_impl(abs_start: jax.Array, abs_end: jax.Array,
                          gap: jax.Array) -> jax.Array:
    run_end = jax.lax.cummax(abs_end)
    new = abs_start[1:] > (run_end[:-1] + gap)
    return jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(new.astype(jnp.int32))]
    )


def chained_gap_cluster_ids(
    abs_start_sorted: np.ndarray | jax.Array,
    abs_end_sorted: np.ndarray | jax.Array,
    gap_ps: float,
) -> jax.Array:
    """Device cluster ids for rows sorted by abs_start: join while
    start <= running-max(end) + gap. Exact f64 compare under x64."""
    n = int(np.shape(abs_start_sorted)[0])
    if n == 0:
        return jnp.zeros(0, jnp.int32)
    with jax.enable_x64(True):
        s = jnp.asarray(np.asarray(abs_start_sorted, dtype=np.float64))
        e = jnp.asarray(np.asarray(abs_end_sorted, dtype=np.float64))
        g = jnp.asarray(float(gap_ps), dtype=jnp.float64)
        return _chained_gap_ids_impl(s, e, g)


# ---------------------------------------------------------------------------
# fully on-device grouping with fixed-capacity per-event aggregates
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("num_segments",))
def segment_aggregates(
    event_ids: jax.Array,
    timestamps: jax.Array,
    areas: jax.Array,
    heights: jax.Array,
    num_segments: int,
) -> Dict[str, jax.Array]:
    """Per-event aggregates via segment reductions (device).

    ``num_segments`` is a static capacity (use n_hits as the safe bound).
    Returns padded arrays; rows >= n_events are zero / identity values.
    """
    ones = jnp.ones_like(event_ids, dtype=jnp.int32)
    n_hits = jax.ops.segment_sum(ones, event_ids, num_segments=num_segments)
    t_min = jax.ops.segment_min(timestamps, event_ids, num_segments=num_segments)
    t_max = jax.ops.segment_max(timestamps, event_ids, num_segments=num_segments)
    area_sum = jax.ops.segment_sum(areas, event_ids, num_segments=num_segments)
    height_max = jax.ops.segment_max(heights, event_ids, num_segments=num_segments)
    present = n_hits > 0
    return {
        "n_hits": n_hits,
        "t_min": jnp.where(present, t_min, 0),
        "t_max": jnp.where(present, t_max, 0),
        "area_sum": jnp.where(present, area_sum, 0),
        "height_max": jnp.where(present, height_max, 0),
        "n_events": jnp.sum(present.astype(jnp.int32)),
    }


@partial(jax.jit, static_argnames=("n_channels",))
def _pair_events_impl(
    ts_flat: jax.Array,
    ts_offsets: jax.Array,
    ts_counts: jax.Array,
    a_flat: jax.Array,
    a_offsets: jax.Array,
    a_counts: jax.Array,
    h_flat: jax.Array,
    h_offsets: jax.Array,
    h_counts: jax.Array,
    span_ns: jax.Array,
    window_ns: jax.Array,
    n_channels: int,
) -> Dict[str, jax.Array]:
    """Pairing columns for EVERY event (trace under x64); the host applies
    the keep mask (dynamic shape) after the fetch.

    Per-event cells live in the flat hit layout (values + offsets + counts)
    — the columnar representation the device grouping pass produces — so
    every derived column is one vectorized gather instead of the reference's
    per-row .apply (reference: processing/analyzer.py:66-150).
    """
    n_events = ts_offsets.shape[0]
    keep = span_ns <= window_ns

    def gather(flat, idx, ok):
        safe = jnp.clip(idx, 0, jnp.maximum(flat.shape[0] - 1, 0))
        vals = flat[safe].astype(jnp.float64)
        return jnp.where(ok & (flat.shape[0] > 0), vals, jnp.nan)

    # delta stays in integer ps on device: XLA rewrites /1000.0 into a
    # multiply-by-reciprocal, which differs from the host oracle by ULPs —
    # the host performs the final ns division instead
    has = ts_counts > 0
    hi = jnp.maximum(ts_flat.shape[0] - 1, 0)
    f_ts = ts_flat[jnp.clip(ts_offsets, 0, hi)]
    l_ts = ts_flat[jnp.clip(ts_offsets + ts_counts - 1, 0, hi)]
    delta_ps = jnp.where(has, l_ts - f_ts, 0)

    area_ch = []
    height_ch = []
    for i in range(n_channels):
        area_ch.append(gather(a_flat, a_offsets + i, a_counts > i))
        height_ch.append(gather(h_flat, h_offsets + i, h_counts > i))
    return {
        "keep": keep,
        "has_ts": has,
        "delta_ps": delta_ps,
        "area_ch": jnp.stack(area_ch, axis=1) if n_channels else
        jnp.zeros((n_events, 0), jnp.float64),
        "height_ch": jnp.stack(height_ch, axis=1) if n_channels else
        jnp.zeros((n_events, 0), jnp.float64),
    }


def pair_events_device(
    ts: tuple,
    areas: tuple,
    heights: tuple,
    span_ns: np.ndarray,
    time_window_ns: float,
    n_channels: int,
) -> Dict[str, np.ndarray]:
    """Device pairing pass over the flat (values, offsets, counts) event
    layout — ``ts``/``areas``/``heights`` are each such a triple. Returns
    host arrays: keep mask, delta_t, (n_events, n_channels) area/height
    matrices — NaN where an event has fewer hits than the channel index,
    matching the host oracle bit-for-bit."""
    n_events = int(np.shape(ts[1])[0])
    if n_events == 0:
        return {
            "keep": np.zeros(0, bool),
            "delta_t": np.zeros(0, np.float64),
            "area_ch": np.zeros((0, n_channels), np.float64),
            "height_ch": np.zeros((0, n_channels), np.float64),
        }
    # fetch once; the ns division runs on host (bit-parity with the oracle)
    with jax.enable_x64(True):
        out = _pair_events_impl(
            jnp.asarray(np.asarray(ts[0], np.int64)),
            jnp.asarray(np.asarray(ts[1], np.int64)),
            jnp.asarray(np.asarray(ts[2], np.int64)),
            jnp.asarray(np.asarray(areas[0], np.float64)),
            jnp.asarray(np.asarray(areas[1], np.int64)),
            jnp.asarray(np.asarray(areas[2], np.int64)),
            jnp.asarray(np.asarray(heights[0], np.float64)),
            jnp.asarray(np.asarray(heights[1], np.int64)),
            jnp.asarray(np.asarray(heights[2], np.int64)),
            jnp.asarray(np.asarray(span_ns, np.float64)),
            jnp.asarray(float(time_window_ns), jnp.float64),
            n_channels=int(n_channels),
        )
    res = {k: np.asarray(v) for k, v in out.items()}
    res["delta_t"] = np.where(
        res.pop("has_ts"), res.pop("delta_ps") / 1000.0, np.nan
    )
    return res


def group_events_device(
    timestamps: np.ndarray,
    channels: np.ndarray,
    areas: np.ndarray,
    heights: np.ndarray,
    time_window_ns: float,
    presorted: bool = False,
) -> Dict[str, np.ndarray]:
    """Full device grouping pass: sort (optional) -> event ids -> aggregates.

    Returns host arrays: per-hit ``order`` (sort permutation into time order),
    per-hit ``event_id`` (aligned with ``order``), and padded per-event
    aggregates with ``n_events``. The caller slices the padded aggregates to
    ``n_events`` rows. This is the device core behind the df_events plugin;
    the ragged per-event cell lists (a pandas API contract) are assembled on
    host from ``order``/``event_id``.
    """
    ts = np.asarray(timestamps, dtype=np.int64)
    n = len(ts)
    if n == 0:
        return {
            "order": np.zeros(0, np.int64),
            "event_id": np.zeros(0, np.int32),
            "n_events": 0,
            "t_min": np.zeros(0, np.int64),
            "t_max": np.zeros(0, np.int64),
            "n_hits": np.zeros(0, np.int32),
        }
    if presorted:
        order = np.arange(n, dtype=np.int64)
        ts_sorted = ts
    else:
        order = np.argsort(ts, kind="stable")
        ts_sorted = ts[order]

    eid = anchor_window_event_ids(ts_sorted, time_window_ns * 1e3)

    with jax.enable_x64(True):
        agg = segment_aggregates(
            eid,
            jnp.asarray(ts_sorted),
            jnp.asarray(np.asarray(areas, np.float64)[order]),
            jnp.asarray(np.asarray(heights, np.float64)[order]),
            num_segments=n,
        )
    eid_host = np.asarray(eid)
    n_events = int(eid_host[-1]) + 1
    return {
        "order": order,
        "event_id": eid_host,
        "n_events": n_events,
        "t_min": np.asarray(agg["t_min"])[:n_events],
        "t_max": np.asarray(agg["t_max"])[:n_events],
        "n_hits": np.asarray(agg["n_hits"])[:n_events],
        "area_sum": np.asarray(agg["area_sum"])[:n_events],
        "height_max": np.asarray(agg["height_max"])[:n_events],
    }
