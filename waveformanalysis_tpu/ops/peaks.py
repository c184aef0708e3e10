"""Peak detection kernel: scipy.signal.find_peaks parity on device.

Device replacement for the reference per-waveform scipy loop
(reference: waveform_analysis/core/plugins/builtin/cpu/peak_finding.py:
446-620). Implements the find_peaks pipeline — plateau-aware local maxima,
height filter, greedy distance pruning by height priority, prominence with
full-window bases, and rel_height=0.5 width evaluation with linearly
interpolated left/right ips — entirely as batched array ops:

- local maxima: forward-filled sign of the last nonzero difference marks
  plateau right edges; the fill *index* recovers the left edge, giving the
  scipy plateau-midpoint position;
- candidates compact into a fixed (n, K) capacity via an argsort on
  position-keyed scores (static shapes; overflow is counted, not silent);
- distance/prominence/width evaluate with a K-step loop of (n, L) masked
  reductions — K is small (default 32) so the sweep stays bandwidth-bound.

Results are (n, K) arrays + validity mask; hosts compact them to flat hit
tables. Positions are exact vs scipy; ips match to float tolerance. One
caveat: scipy's distance pruning ranks peaks with an UNSTABLE np.argsort, so
which of two EXACTLY-equal-height peaks within `distance` survives is
implementation-defined there; this kernel resolves such ties
deterministically (later position wins, the stable-sort order).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

KERNEL_VERSION = "peaks-v2"  # v2: neighbor-threshold condition
DEFAULT_MAX_PEAKS = 32

_NEG = -3.0e38  # sentinel below any float32 signal


def compact_first_k(flags: jax.Array, arrays: Tuple[jax.Array, ...], K: int,
                    fills: Tuple[Any, ...]) -> Tuple[Tuple[jax.Array, ...], jax.Array]:
    """Compact the first K flagged columns (in positional order) of each
    (n, L) array into (n, K), without a sort.

    A cumsum rank plus K argmax passes is bandwidth-bound and needs no sort
    (a formulation chosen for a compiler whose sorts were slow; not yet
    re-derived for the GPU). Returns (compacted_arrays, ok_mask).
    """
    n = flags.shape[0]
    rank = jnp.cumsum(flags.astype(jnp.int32), axis=1)
    # rows never have more than max(rank) flagged columns: loop only that far
    kmax = jnp.minimum(K, jnp.max(rank[:, -1]))

    def slot(carry):
        k, outs, ok_c = carry
        hit = flags & (rank == (k + 1))  # at most one True per row
        idx = jnp.argmax(hit, axis=1)
        ok = jnp.any(hit, axis=1)
        new_outs = tuple(
            o.at[:, k].set(jnp.where(
                ok, jnp.take_along_axis(a, idx[:, None], axis=1)[:, 0], f
            ))
            for o, a, f in zip(outs, arrays, fills)
        )
        return k + 1, new_outs, ok_c.at[:, k].set(ok)

    init_outs = tuple(
        jnp.full((n, K), f, a.dtype) for a, f in zip(arrays, fills)
    )
    _, outs, ok = jax.lax.while_loop(
        lambda c: c[0] < kmax, slot,
        (jnp.int32(0), init_outs, jnp.zeros((n, K), bool)),
    )
    return outs, ok


@partial(
    jax.jit,
    static_argnames=("max_peaks", "distance", "rel_height"),
)
def find_peaks_batch(
    signal: jax.Array,
    height: float,
    prominence: float,
    width: float,
    distance: int = 1,
    max_peaks: int = DEFAULT_MAX_PEAKS,
    rel_height: float = 0.5,
    valid_length: Optional[jax.Array] = None,
    threshold: Optional[Tuple[Optional[float], Optional[float]]] = None,
) -> Dict[str, jax.Array]:
    """find_peaks over a (n, L) batch.

    Returns dict of (n, K) arrays: position (int32, -1 invalid), valid
    (bool), peak_height (signal value), prominences, left_ips, right_ips,
    widths, left_bases, right_bases; plus n_candidates (n,) for overflow
    accounting.
    """
    x = signal.astype(jnp.float32)
    n, L = x.shape
    K = max_peaks
    pos_idx = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)

    if valid_length is None:
        vlen = jnp.full((n,), L, dtype=jnp.int32)
    else:
        vlen = valid_length.astype(jnp.int32)
    in_range = pos_idx < vlen[:, None]
    # mask out-of-range samples to -inf so they never form maxima
    x = jnp.where(in_range, x, _NEG)

    # ---- local maxima with plateau midpoints --------------------------------
    # No L-wide gathers or sorts here (the formulation avoids both; not yet
    # re-derived for the GPU). The last-nonzero-diff index and its
    # rise/fall direction pack into one int (idx*2 + rise) carried by a single
    # cummax; the plateau's value is constant, so the value at the midpoint is
    # just the value at the plateau's right edge, i.e. x[:, :-1] elementwise.
    d = x[:, 1:] - x[:, :-1]  # (n, L-1)
    didx = jax.lax.broadcasted_iota(jnp.int32, (1, L - 1), 1)
    nonzero = d != 0
    packed = jnp.where(nonzero, didx * 2 + (d > 0).astype(jnp.int32), -1)
    # last nonzero diff at or before i-1 (packed; -1 if none)
    prev_ff = jnp.concatenate(
        [jnp.full((n, 1), -1, jnp.int32),
         jax.lax.cummax(packed, axis=1)[:, :-1]],
        axis=1,
    )
    # right edge of a peak plateau at sample i (1 <= i <= L-2):
    # d[i] < 0 and the last nonzero diff before i was a rise
    prev_was_rise = (prev_ff >= 0) & (prev_ff % 2 == 1)
    right_edge_mask = (d < 0) & prev_was_rise  # at diff index i == sample i
    left_edge = jnp.where(prev_ff >= 0, prev_ff // 2 + 1, 0)
    midpoint = (left_edge + didx) // 2  # (n, L-1) plateau midpoint

    is_peak = right_edge_mask
    # scipy never reports a peak at the first/last sample of the (true) wave
    is_peak = is_peak & (midpoint <= (vlen[:, None] - 2)) & (midpoint >= 1)
    # the falling edge must be real: d[i] = x[i+1]-x[i] uses sample i+1, so a
    # diff at i > vlen-2 reads the _NEG padding and would fabricate a peak
    # from a plateau running into the valid-length boundary (scipy, on the
    # unpadded wave, reports nothing there)
    is_peak = is_peak & (didx <= (vlen[:, None] - 2))
    peak_value = x[:, : L - 1]  # plateau value == right-edge sample value
    # height filter applied before compaction (scipy order)
    is_peak = is_peak & (peak_value >= height)

    if threshold is not None:
        # scipy neighbor-threshold condition (after height, before
        # distance): left_thr = x[m] - x[m-1], right_thr = x[m] - x[m+1]
        # at the plateau MIDPOINT m. Without gathers: for a width-1 peak
        # (m == i == left_edge) the neighbors are the adjacent diffs
        # (d[i-1], -d[i]); for a width-2 plateau (m == left_edge == i-1)
        # the left neighbor is d[i-2] and the right neighbor is inside the
        # plateau (0); any wider plateau has both neighbors inside (0, 0)
        # — exactly scipy's behavior of evaluating x[m±1] on the plateau.
        tmin, tmax = threshold
        plateau_w = didx - left_edge + 1  # samples left_edge..i
        d_prev = jnp.concatenate([jnp.zeros((n, 1), x.dtype), d[:, :-1]],
                                 axis=1)
        d_prev2 = jnp.concatenate([jnp.zeros((n, 2), x.dtype), d[:, :-2]],
                                  axis=1)
        zero = jnp.zeros((), x.dtype)
        left_thr = jnp.where(plateau_w == 1, d_prev,
                             jnp.where(plateau_w == 2, d_prev2, zero))
        right_thr = jnp.where(plateau_w == 1, -d, zero)
        if tmin is not None:
            is_peak = is_peak & (jnp.minimum(left_thr, right_thr) >= tmin)
        if tmax is not None:
            is_peak = is_peak & (jnp.maximum(left_thr, right_thr) <= tmax)

    n_candidates = jnp.sum(is_peak, axis=1, dtype=jnp.int32)

    # ---- compact to (n, K) by position --------------------------------------
    # first K peaks in positional order via cumsum ranks + K argmaxes
    # (replaces an argsort over L)
    (positions, values), cand_valid = compact_first_k(
        is_peak, (midpoint, peak_value), K, (-1, _NEG)
    )

    # ---- distance filter: greedy by height priority -------------------------
    n_compacted = jnp.sum(cand_valid, axis=1, dtype=jnp.int32)
    kmax = jnp.minimum(K, jnp.max(n_compacted))
    if distance > 1:
        # priority: higher value first; ties -> later position first (scipy
        # processes a stable argsort(values) from the end). Computed as a
        # K^2 comparison-count rank instead of a sort.
        v_i = values[:, :, None]  # candidate i
        v_j = values[:, None, :]  # candidate j
        jdx = jax.lax.broadcasted_iota(jnp.int32, (1, K, K), 2)
        idx = jax.lax.broadcasted_iota(jnp.int32, (1, K, K), 1)
        beats_i = (v_j > v_i) | ((v_j == v_i) & (jdx > idx))
        prio_rank = jnp.sum(beats_i, axis=2).astype(jnp.int32)  # (n, K): 0 = first
        pos_f = positions.astype(jnp.int32)
        kidx2 = jax.lax.broadcasted_iota(jnp.int32, (n, K), 1)

        def dist_body(carry):
            k, keep = carry
            hit = prio_rank == k  # exactly one True per row
            sel = jnp.argmax(hit, axis=1)  # (n,) candidate index, k-th priority
            p = jnp.take_along_axis(pos_f, sel[:, None], axis=1)[:, 0]  # (n,)
            v = jnp.take_along_axis(cand_valid, sel[:, None], axis=1)[:, 0]
            kept_k = jnp.take_along_axis(keep, sel[:, None], axis=1)[:, 0]
            # suppress any other candidate within `distance`, not itself,
            # only if this candidate is itself still kept and valid
            close = (jnp.abs(pos_f - p[:, None]) < distance)
            suppress = close & (kidx2 != sel[:, None]) & (kept_k & v)[:, None]
            return k + 1, keep & ~suppress

        _, keep = jax.lax.while_loop(
            lambda c: c[0] < kmax, dist_body, (jnp.int32(0), cand_valid)
        )
        cand_valid = cand_valid & keep
        positions = jnp.where(cand_valid, positions, -1)
        values = jnp.where(cand_valid, values, _NEG)

    # ---- prominence + bases (wlen = full window, scipy default) -------------
    prominences = jnp.zeros((n, K), jnp.float32)
    left_bases = jnp.zeros((n, K), jnp.int32)
    right_bases = jnp.zeros((n, K), jnp.int32)
    left_ips = jnp.zeros((n, K), jnp.float32)
    right_ips = jnp.zeros((n, K), jnp.float32)

    pos_row = pos_idx  # (1, L)

    def peak_body(carry):
        k, proms, lbases, rbases, lips, rips = carry
        p = positions[:, k]  # (n,)
        v = values[:, k]
        ok = cand_valid[:, k]
        p_safe = jnp.maximum(p, 0)

        higher = x > v[:, None]
        # left base: search [prev_higher+1 .. p] for the minimum; scipy takes
        # the LAST index of the minimum going left from the peak == first
        # occurrence scanning right? scipy's left base = argmin over the
        # interval, taking the leftmost minimal sample.
        prev_higher = jnp.max(
            jnp.where(higher & (pos_row < p[:, None]), pos_row, -1), axis=1
        )  # (n,)
        lmask = (pos_row >= (prev_higher + 1)[:, None]) & (pos_row <= p[:, None]) & in_range
        lvals = jnp.where(lmask, x, jnp.inf)
        left_min = jnp.min(lvals, axis=1)
        # scipy walks leftward updating on strict '<': ties resolve to the
        # RIGHTMOST occurrence of the minimum
        lbase = jnp.max(
            jnp.where(lmask & (x == left_min[:, None]), pos_row, -1), axis=1
        ).astype(jnp.int32)
        lbase = jnp.maximum(lbase, 0)

        next_higher = jnp.min(
            jnp.where(higher & (pos_row > p[:, None]), pos_row, L), axis=1
        )
        rmask = (pos_row >= p[:, None]) & (pos_row <= (next_higher - 1)[:, None]) & in_range
        rvals = jnp.where(rmask, x, jnp.inf)
        right_min = jnp.min(rvals, axis=1)
        # scipy walks rightward updating on strict '<': ties resolve to the
        # LEFTMOST occurrence of the minimum
        rbase = jnp.argmin(rvals, axis=1).astype(jnp.int32)

        prom = v - jnp.maximum(left_min, right_min)
        prom = jnp.where(ok, prom, 0.0)

        # ---- width at rel_height -------------------------------------------
        h_eval = v - prom * rel_height
        # left: largest j in [lbase, p] with x[j] < h_eval
        # scipy stops at the first sample with x <= h going left; it only
        # interpolates when strictly below
        below_l = (x <= h_eval[:, None]) & (pos_row >= lbase[:, None]) & (
            pos_row <= p[:, None]
        ) & in_range
        jl = jnp.max(jnp.where(below_l, pos_row, -1), axis=1)
        has_l = jl >= 0
        jl_safe = jnp.clip(jl, 0, L - 2)
        xl = jnp.take_along_axis(x, jl_safe[:, None], axis=1)[:, 0]
        xl1 = jnp.take_along_axis(x, (jl_safe + 1)[:, None], axis=1)[:, 0]
        lip = jnp.where(
            has_l,
            jnp.where(
                xl < h_eval,
                jl + (h_eval - xl) / jnp.where(xl1 != xl, xl1 - xl, 1.0),
                jl.astype(jnp.float32),
            ),
            lbase.astype(jnp.float32),
        )
        # right: smallest j in [p, rbase] with x[j] < h_eval
        below_r = (x <= h_eval[:, None]) & (pos_row <= rbase[:, None]) & (
            pos_row >= p[:, None]
        ) & in_range
        jr = jnp.min(jnp.where(below_r, pos_row, L), axis=1)
        has_r = jr < L
        jr_safe = jnp.clip(jr, 1, L - 1)
        xr = jnp.take_along_axis(x, jr_safe[:, None], axis=1)[:, 0]
        xr_1 = jnp.take_along_axis(x, (jr_safe - 1)[:, None], axis=1)[:, 0]
        rip = jnp.where(
            has_r,
            jnp.where(
                xr < h_eval,
                jr - (h_eval - xr) / jnp.where(xr_1 != xr, xr_1 - xr, 1.0),
                jr.astype(jnp.float32),
            ),
            rbase.astype(jnp.float32),
        )

        upd = lambda a, vals: a.at[:, k].set(jnp.where(ok, vals, a[:, k]))
        return (
            k + 1,
            upd(proms, prom),
            upd(lbases, lbase),
            upd(rbases, rbase),
            upd(lips, lip),
            upd(rips, rip),
        )

    # only slots below the batch-max candidate count hold real peaks; the
    # while_loop skips the dead tail of the fixed K capacity
    _, prominences, left_bases, right_bases, left_ips, right_ips = (
        jax.lax.while_loop(
            lambda c: c[0] < kmax, peak_body,
            (jnp.int32(0), prominences, left_bases, right_bases,
             left_ips, right_ips),
        )
    )

    widths = right_ips - left_ips
    # prominence + width filters (scipy order: prominence, then width)
    final_valid = cand_valid & (prominences >= prominence) & (widths >= width)
    positions = jnp.where(final_valid, positions, -1)

    return {
        "position": positions.astype(jnp.int32),
        "valid": final_valid,
        "peak_value": values,
        "prominence": prominences,
        "left_ips": left_ips,
        "right_ips": right_ips,
        "widths": widths,
        "left_bases": left_bases,
        "right_bases": right_bases,
        "n_candidates": n_candidates,
    }


@partial(jax.jit, static_argnames=("window_extension", "method"))
def peak_heights_batch(
    waves: jax.Array,
    left_ips: jax.Array,
    right_ips: jax.Array,
    valid: jax.Array,
    method: str = "minmax",
    window_extension: int = 4,
) -> jax.Array:
    """Per-peak height from the ORIGINAL waveform
    (reference: peak_finding.py:567-614).

    minmax: max-min over [round(l)-ext, round(r)+ext);
    diff: sum of -diff(wave) over [round(l), round(r)).
    """
    n, L = waves.shape
    K = left_ips.shape[1]
    w = waves.astype(jnp.float32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)

    start = jnp.clip(jnp.round(left_ips).astype(jnp.int32), 0, L - 1)
    end = jnp.clip(jnp.round(right_ips).astype(jnp.int32), 0, L - 1)

    def body(k, out):
        s = start[:, k][:, None]
        e = end[:, k][:, None]
        if method == "minmax":
            ws = jnp.maximum(s - window_extension, 0)
            we = jnp.minimum(e + window_extension, L)
            m = (pos >= ws) & (pos < we)
            mx = jnp.max(jnp.where(m, w, -jnp.inf), axis=1)
            mn = jnp.min(jnp.where(m, w, jnp.inf), axis=1)
            h = jnp.where(jnp.any(m, axis=1), mx - mn, 0.0)
        else:  # diff
            d = -(w[:, 1:] - w[:, :-1])
            dpos = pos[:, : L - 1]
            m = (dpos >= s) & (dpos < e)
            h = jnp.sum(jnp.where(m, d, 0.0), axis=1)
        return out.at[:, k].set(jnp.where(valid[:, k], h, 0.0))

    out = jnp.zeros((n, K), jnp.float32)
    return jax.lax.fori_loop(0, K, body, out)


def compact_hits(
    results: Dict[str, np.ndarray],
    heights: np.ndarray,
    timestamps: np.ndarray,
    boards: np.ndarray,
    channels: np.ndarray,
    record_ids: np.ndarray,
    dt_ns: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Flatten (n, K) device results into flat hit arrays (host side).

    Global timestamp = event timestamp + position * dt_ns * 1000 (ps).
    """
    valid = np.asarray(results["valid"])
    rows, cols = np.nonzero(valid)
    return hit_columns_from_flat(
        rows=rows,
        position=np.asarray(results["position"])[rows, cols],
        heights=np.asarray(heights)[rows, cols],
        left_ips=np.asarray(results["left_ips"])[rows, cols],
        right_ips=np.asarray(results["right_ips"])[rows, cols],
        timestamps=timestamps, boards=boards, channels=channels,
        record_ids=record_ids, dt_ns=dt_ns,
    )


def hit_columns_from_flat(
    rows: np.ndarray,
    position: np.ndarray,
    heights: np.ndarray,
    left_ips: np.ndarray,
    right_ips: np.ndarray,
    timestamps: np.ndarray,
    boards: np.ndarray,
    channels: np.ndarray,
    record_ids: np.ndarray,
    dt_ns: np.ndarray,
) -> Dict[str, np.ndarray]:
    """HIT columns from already-compacted per-hit slot values.

    ``rows`` maps each hit to its source waveform (row-major slot order —
    exactly the order ``np.nonzero(valid)`` produces). Shared by the host
    compaction above and the device-compacted fused-bundle transfer path.
    """
    pos = np.asarray(position).astype(np.int64)
    dt = np.asarray(dt_ns, dtype=np.int64)[rows]
    return {
        "position": pos,
        "height": np.asarray(heights).astype(np.float32),
        "integral": np.zeros(len(rows), dtype=np.float32),
        "edge_start": np.asarray(left_ips).astype(np.float32),
        "edge_end": np.asarray(right_ips).astype(np.float32),
        "dt": dt.astype(np.int32),
        "timestamp": np.asarray(timestamps, dtype=np.int64)[rows] + pos * dt * 1000,
        "board": np.asarray(boards, dtype=np.int16)[rows],
        "channel": np.asarray(channels, dtype=np.int16)[rows],
        "record_id": np.asarray(record_ids, dtype=np.int64)[rows],
    }
