"""Streaming-scan kernels for the GPU: Pallas through Triton.

The XLA formulations in ops/peaks.py and ops/hits.py evaluate every
candidate slot with masked reductions over the whole (n, L) wave matrix —
K passes per slot family. These kernels instead walk the sample axis of a
time-major (L, n) signal inside the kernel:

- one event per lane, ``BLOCK`` events per program; programs are
  independent and nothing carries from one grid step to the next;
- each step loads one time-major row (``BLOCK`` consecutive floats, one
  coalesced load) and updates per-event state held in registers;
- per-slot results are scattered straight into the (K, n) output refs
  (one row per slot), so no slot-indexed state is carried through a loop.
  Slot passes read their inputs back from those refs, in groups of
  ``SLOT_GROUP`` slots per walk, and only as far as the block's largest
  candidate count.

Outputs follow the XLA contracts exactly (same keys, shapes, fills for
empty slots); the XLA functions stay the CPU path and the tests' reference.
There is no fallback: on a GPU these kernels either compile or raise.
``interpret=True`` runs them through the Pallas interpreter for the CPU
tests only.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 128        # events per program, one per lane
NUM_WARPS = 4      # 128 threads: one event per thread
SLOT_GROUP = 4     # peak slots evaluated per time walk

_NEG = -3.0e38
_INF = 3.0e38

f32 = jnp.float32
i32 = jnp.int32


def _round_up(n: int, m: int) -> int:
    return n + (-n) % m


def _pallas(kernel, n_pad: int, out_shape, interpret: bool, name: str):
    return pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )


def _block():
    """(cols, lanes) of this program's events: a row slice and the
    per-lane column indices for gathers/scatters."""
    base = pl.program_id(0) * BLOCK
    return pl.ds(base, BLOCK), base + jnp.arange(BLOCK, dtype=i32)


# --------------------------------------------------------------------------
# find_peaks (scipy parity; contract of ops.peaks.find_peaks_batch)
# --------------------------------------------------------------------------

def _peaks_kernel(
    x_ref, vlen_ref,
    pos_ref, valid_ref, pval_ref, prom_ref, lips_ref, rips_ref, wid_ref,
    lbase_ref, rbase_ref, ncand_ref,
    *, L: int, K: int, K_pad: int, height: float, prominence: float,
    width: float, distance: int, rel_height: float,
):
    cols, lanes = _block()
    det_len = vlen_ref[cols]
    zi = jnp.zeros((BLOCK,), i32)
    zf = jnp.zeros((BLOCK,), f32)

    def x_at(t):
        return jnp.where(t < det_len, x_ref[t, cols], _NEG)

    def x_gather(idx):
        return jnp.where(idx < det_len, plgpu.load(x_ref.at[idx, lanes]),
                         _NEG)

    def init_slot(k, c):
        pos_ref[k, cols] = zi - 1
        valid_ref[k, cols] = zi
        pval_ref[k, cols] = zf + _NEG
        prom_ref[k, cols] = zf
        lips_ref[k, cols] = zf
        rips_ref[k, cols] = zf
        wid_ref[k, cols] = zf
        lbase_ref[k, cols] = zi
        rbase_ref[k, cols] = zi
        return c

    lax.fori_loop(0, K_pad, init_slot, 0)

    # ---- pass 1: plateau-midpoint candidates, scattered to slot rows ----
    def p1(t, c):
        prev_x, rise, left, cnt = c
        cur = x_at(t)
        d = cur - prev_x
        mid = lax.div(left + (t - 1), 2)
        emit = ((d < 0) & (rise > 0) & (t <= det_len - 1) & (mid >= 1)
                & (mid <= det_len - 2) & (prev_x >= height))
        slot = jnp.minimum(cnt, K - 1)
        keep = emit & (cnt < K)
        plgpu.store(pos_ref.at[slot, lanes], mid, mask=keep)
        plgpu.store(pval_ref.at[slot, lanes], prev_x, mask=keep)
        nz = d != 0
        return (cur, jnp.where(nz, (d > 0).astype(i32), rise),
                jnp.where(nz, t, left), cnt + emit.astype(i32))

    _, _, _, cnt = lax.fori_loop(1, L, p1, (x_at(0), zi, zi, zi))
    ncand_ref[cols] = cnt
    n_slots = jnp.minimum(cnt, K)
    kmax = jnp.max(n_slots)

    # ---- distance pruning: greedy by height priority (scipy order) ----
    # keep flags live in valid_ref rows, "already kept" marks in lbase_ref
    # rows; both are overwritten by the slot passes below
    if distance > 1:
        def init_keep(k, c):
            valid_ref[k, cols] = (k < n_slots).astype(i32)
            return c

        lax.fori_loop(0, kmax, init_keep, 0)

        def select(j, c):
            best, best_v = c
            free = (valid_ref[j, cols] > 0) & (lbase_ref[j, cols] == 0)
            v = pval_ref[j, cols]
            # ties: the later slot has priority (stable-sort order)
            better = free & ((best < 0) | (v >= best_v))
            return jnp.where(better, j, best), jnp.where(better, v, best_v)

        def prune_round(c):
            best, _ = lax.fori_loop(0, kmax, select, (zi - 1, zf + _NEG))
            found = best >= 0
            b = jnp.maximum(best, 0)
            plgpu.store(lbase_ref.at[b, lanes], zi + 1, mask=found)
            b_pos = plgpu.load(pos_ref.at[b, lanes])

            def suppress(j, c2):
                close = (found & (j != best)
                         & (jnp.abs(pos_ref[j, cols] - b_pos) < distance))
                valid_ref[j, cols] = jnp.where(close, 0, valid_ref[j, cols])
                return c2

            lax.fori_loop(0, kmax, suppress, 0)
            return found.astype(i32).max()

        lax.while_loop(lambda go: go > 0, prune_round, jnp.int32(1))

    # ---- slot passes: prominence bases, then rel-height crossings ----
    G = SLOT_GROUP

    def slot_group(g, c):
        ks = [g * G + j for j in range(G)]
        p = [pos_ref[k, cols] for k in ks]
        v = [pval_ref[k, cols] for k in ks]
        ok = [k < n_slots for k in ks]
        if distance > 1:
            ok = [o & (valid_ref[k, cols] > 0) for o, k in zip(ok, ks)]

        def p2(t, st):
            xt = x_at(t)
            ind = t < det_len
            out = []
            for j in range(G):
                lmin, lb, nh, rmin, rb = st[j]
                reset = (t < p[j]) & (xt > v[j])
                lmin = jnp.where(reset, _INF, lmin)
                lb = jnp.where(reset, t + 1, lb)
                upd = (t <= p[j]) & ind & (xt <= lmin)
                lb = jnp.where(upd, t, lb)
                lmin = jnp.where(upd, xt, lmin)
                nh = nh | ((t > p[j]) & (xt > v[j])).astype(i32)
                updr = (t >= p[j]) & (nh == 0) & ind & (xt < rmin)
                rb = jnp.where(updr, t, rb)
                rmin = jnp.where(updr, xt, rmin)
                out.append((lmin, lb, nh, rmin, rb))
            return tuple(out)

        init2 = tuple((zf + _INF, zi, zi, zf + _INF, zi + L)
                      for _ in range(G))
        st2 = lax.fori_loop(0, L, p2, init2)
        lb = [s[1] for s in st2]
        rb = [s[4] for s in st2]
        prom = [jnp.where(ok[j], v[j] - jnp.maximum(st2[j][0], st2[j][3]),
                          0.0) for j in range(G)]
        h = [v[j] - prom[j] * rel_height for j in range(G)]

        def p3(t, st):
            xt = x_at(t)
            ind = t < det_len
            out = []
            for j in range(G):
                jl, jr = st[j]
                below_j = (xt <= h[j]) & ind
                jl = jnp.where(below_j & (t >= lb[j]) & (t <= p[j]), t, jl)
                jr = jnp.where(below_j & (t >= p[j]) & (t <= rb[j])
                               & (jr >= L), t, jr)
                out.append((jl, jr))
            return tuple(out)

        st3 = lax.fori_loop(0, L, p3, tuple((zi - 1, zi + L)
                                             for _ in range(G)))
        for j, k in enumerate(ks):
            jl, jr = st3[j]
            jl_s = jnp.clip(jl, 0, L - 2)
            xl = x_gather(jl_s)
            xl1 = x_gather(jl_s + 1)
            lip = jnp.where(
                jl >= 0,
                jnp.where(xl < h[j],
                          jl + (h[j] - xl) / jnp.where(xl1 != xl, xl1 - xl,
                                                       1.0),
                          jl.astype(f32)),
                lb[j].astype(f32),
            )
            jr_s = jnp.clip(jr, 1, L - 1)
            xr = x_gather(jr_s)
            xr1 = x_gather(jr_s - 1)
            rip = jnp.where(
                jr < L,
                jnp.where(xr < h[j],
                          jr - (h[j] - xr) / jnp.where(xr1 != xr, xr1 - xr,
                                                       1.0),
                          jr.astype(f32)),
                rb[j].astype(f32),
            )
            lip = jnp.where(ok[j], lip, 0.0)
            rip = jnp.where(ok[j], rip, 0.0)
            wk = rip - lip
            final = ok[j] & (prom[j] >= prominence) & (wk >= width)
            pos_ref[k, cols] = jnp.where(final, p[j], -1)
            valid_ref[k, cols] = final.astype(i32)
            pval_ref[k, cols] = jnp.where(ok[j], v[j], _NEG)
            prom_ref[k, cols] = prom[j]
            lips_ref[k, cols] = lip
            rips_ref[k, cols] = rip
            wid_ref[k, cols] = wk
            lbase_ref[k, cols] = jnp.where(ok[j], lb[j], 0)
            rbase_ref[k, cols] = jnp.where(ok[j], rb[j], 0)
        return c

    lax.fori_loop(0, lax.div(kmax + (G - 1), G), slot_group, 0)


@partial(
    jax.jit,
    static_argnames=("height", "prominence", "width", "distance",
                     "max_peaks", "rel_height", "interpret"),
)
def find_peaks_scan(
    signal: jax.Array,
    height: float,
    prominence: float,
    width: float,
    distance: int = 1,
    max_peaks: int = 32,
    rel_height: float = 0.5,
    valid_length: jax.Array = None,
    interpret: bool = False,
) -> Dict[str, jax.Array]:
    """find_peaks over an (n, L) batch — drop-in for
    ops.peaks.find_peaks_batch without the neighbor-threshold condition."""
    x = signal.astype(f32)
    n, L = x.shape
    K = int(max_peaks)
    K_pad = _round_up(K, SLOT_GROUP)
    vlen = (jnp.full((n,), L, i32) if valid_length is None
            else valid_length.astype(i32))
    n_pad = _round_up(n, BLOCK)
    x_T = jnp.pad(x, ((0, n_pad - n), (0, 0))).T
    vlen = jnp.pad(vlen, (0, n_pad - n))

    kernel = partial(
        _peaks_kernel, L=L, K=K, K_pad=K_pad, height=float(height),
        prominence=float(prominence), width=float(width),
        distance=int(distance), rel_height=float(rel_height),
    )
    slot_dtypes = (i32, i32, f32, f32, f32, f32, f32, i32, i32)
    outs = _pallas(
        kernel, n_pad,
        [jax.ShapeDtypeStruct((K_pad, n_pad), dt) for dt in slot_dtypes]
        + [jax.ShapeDtypeStruct((n_pad,), i32)],
        interpret, "find_peaks_scan",
    )(x_T, vlen)

    keys = ("position", "valid", "peak_value", "prominence", "left_ips",
            "right_ips", "widths", "left_bases", "right_bases")
    result = {k: o[:K, :n].T for k, o in zip(keys, outs[:9])}
    result["valid"] = result["valid"] > 0
    result["n_candidates"] = outs[9][:n]
    return result


# --------------------------------------------------------------------------
# threshold runs (contract of ops.hits.threshold_hits_batch)
# --------------------------------------------------------------------------

def _hits_kernel(
    x_ref, thr_ref, vlen_ref,
    valid_ref, pos_ref, height_ref, integ_ref, segs_ref, sege_ref,
    rstart_ref, rend_ref, nruns_ref,
    *, L: int, K: int, left_extension: int, right_extension: int,
):
    cols, lanes = _block()
    thr = thr_ref[cols]
    el = vlen_ref[cols]
    zi = jnp.zeros((BLOCK,), i32)
    zf = jnp.zeros((BLOCK,), f32)
    le, re = left_extension, right_extension

    def init_slot(k, c):
        # empty-slot fills of the XLA compaction (start 0, inclusive end 0)
        valid_ref[k, cols] = zi
        pos_ref[k, cols] = zi
        height_ref[k, cols] = zf
        integ_ref[k, cols] = zf
        segs_ref[k, cols] = zi
        sege_ref[k, cols] = zi + min(1 + re, L)
        rstart_ref[k, cols] = zi
        rend_ref[k, cols] = zi + 1
        return c

    lax.fori_loop(0, K, init_slot, 0)

    def close(ending, t_end, n_runs, run_s, acc, hmax, hpos):
        """Write the slot of each run that ends at ``t_end`` (exclusive),
        after folding in its right-extension samples."""
        for j in range(re):
            if isinstance(t_end, int) and t_end + j >= L:
                break
            idx = t_end + j
            xj = x_ref[jnp.minimum(idx, L - 1), cols]
            inseg = ending & (idx < L)
            acc = jnp.where(inseg, acc + jnp.maximum(xj, 0.0), acc)
            better = inseg & (xj > hmax)
            hpos = jnp.where(better, idx, hpos)
            hmax = jnp.where(better, xj, hmax)
        slot = n_runs - 1
        write = ending & (slot < K)
        s = jnp.clip(slot, 0, K - 1)
        plgpu.store(valid_ref.at[s, lanes], zi + 1, mask=write)
        plgpu.store(pos_ref.at[s, lanes], hpos, mask=write)
        plgpu.store(height_ref.at[s, lanes], hmax, mask=write)
        plgpu.store(integ_ref.at[s, lanes], acc, mask=write)
        plgpu.store(segs_ref.at[s, lanes], jnp.maximum(run_s - le, 0),
                    mask=write)
        plgpu.store(sege_ref.at[s, lanes], zi + jnp.minimum(t_end + re, L),
                    mask=write)
        plgpu.store(rstart_ref.at[s, lanes], run_s, mask=write)
        plgpu.store(rend_ref.at[s, lanes], zi + t_end, mask=write)

    def body(t, c):
        prev_on, n_runs, run_s, acc, hmax, hpos = c[:6]
        hist = c[6:]  # x[t-1], x[t-2], ... (left-extension lookback)
        xt = x_ref[t, cols]
        on = (xt >= thr) & (t < el)
        start = on & (prev_on == 0)
        ending = (prev_on > 0) & ~on

        # masked stores every step: a block-wide pl.when around them
        # measured no faster on the card (PERF.md, occupancy gates)
        close(ending, t, n_runs, run_s, acc, hmax, hpos)

        run_s = jnp.where(start, t, run_s)
        acc = jnp.where(start, 0.0, acc)
        hmax = jnp.where(start, -jnp.inf, hmax)
        hpos = jnp.where(start, 0, hpos)
        for back in range(le, 0, -1):  # positional order
            xb = hist[back - 1]
            inseg = start & (t - back >= 0)
            acc = jnp.where(inseg, acc + jnp.maximum(xb, 0.0), acc)
            better = inseg & (xb > hmax)
            hpos = jnp.where(better, t - back, hpos)
            hmax = jnp.where(better, xb, hmax)
        acc = jnp.where(on, acc + jnp.maximum(xt, 0.0), acc)
        better = on & (xt > hmax)
        hpos = jnp.where(better, t, hpos)
        hmax = jnp.where(better, xt, hmax)
        n_runs = n_runs + start.astype(i32)
        return (on.astype(i32), n_runs, run_s, acc, hmax, hpos,
                xt, *hist[:-1]) if le else (
                on.astype(i32), n_runs, run_s, acc, hmax, hpos)

    init = (zi, zi, zi, zf, zf - jnp.inf, zi) + tuple(zf for _ in range(le))
    out = lax.fori_loop(0, L, body, init)
    prev_on, n_runs, run_s, acc, hmax, hpos = out[:6]
    close(prev_on > 0, L, n_runs, run_s, acc, hmax, hpos)
    nruns_ref[cols] = n_runs


@partial(
    jax.jit,
    static_argnames=("left_extension", "right_extension", "max_hits",
                     "interpret"),
)
def threshold_hits_scan(
    signal: jax.Array,
    thresholds: jax.Array,
    valid_length: jax.Array,
    left_extension: int = 2,
    right_extension: int = 2,
    max_hits: int = 32,
    interpret: bool = False,
) -> Dict[str, jax.Array]:
    """Threshold runs over an (n, L) batch — drop-in for
    ops.hits.threshold_hits_batch."""
    x = signal.astype(f32)
    n, L = x.shape
    K = int(max_hits)
    n_pad = _round_up(n, BLOCK)
    x_T = jnp.pad(x, ((0, n_pad - n), (0, 0))).T
    thr = jnp.pad(thresholds.astype(f32), (0, n_pad - n),
                  constant_values=_INF)
    vlen = jnp.pad(valid_length.astype(i32), (0, n_pad - n))

    kernel = partial(
        _hits_kernel, L=L, K=K, left_extension=int(left_extension),
        right_extension=int(right_extension),
    )
    slot_dtypes = (i32, i32, f32, f32, i32, i32, i32, i32)
    outs = _pallas(
        kernel, n_pad,
        [jax.ShapeDtypeStruct((K, n_pad), dt) for dt in slot_dtypes]
        + [jax.ShapeDtypeStruct((n_pad,), i32)],
        interpret, "threshold_hits_scan",
    )(x_T, thr, vlen)

    keys = ("valid", "position", "height", "integral", "seg_start",
            "seg_end", "run_start", "run_end")
    result = {k: o[:, :n].T for k, o in zip(keys, outs[:8])}
    result["valid"] = result["valid"] > 0
    result["n_runs"] = outs[8][:n]
    return result


# --------------------------------------------------------------------------
# zero-phase IIR (contract of ops.filtering.sosfiltfilt_device)
# --------------------------------------------------------------------------

def _sosfiltfilt_kernel(x_ref, y_ref, fwd_ref, *, sos: Tuple, zi: Tuple,
                        L: int, padlen: int):
    """Odd-reflection padding by index arithmetic, forward cascade into
    ``fwd_ref`` (one row per extended sample), backward cascade reading it
    in reverse; only the central L samples of the backward pass are
    computed and stored. Biquad state lives in registers (transposed
    direct form II)."""
    cols, _ = _block()
    S = len(sos)
    Lp = L + 2 * padlen
    x0 = x_ref[0, cols]
    xl = x_ref[L - 1, cols]

    def cascade(x, z):
        z = list(z)
        for s, (b0, b1, b2, a1, a2) in enumerate(sos):
            y = b0 * x + z[2 * s]
            z[2 * s] = b1 * x - a1 * y + z[2 * s + 1]
            z[2 * s + 1] = b2 * x - a2 * y
            x = y
        return x, tuple(z)

    # forward over the odd-reflected extension, one loop per region so every
    # index is plain arithmetic on the loop counter
    def fwd_left(t, z):   # ext[t] = 2 x[0] - x[padlen - t]
        y, z = cascade(2.0 * x0 - x_ref[padlen - t, cols], z)
        fwd_ref[t, cols] = y
        return z

    def fwd_mid(t, z):    # ext[t] = x[t - padlen]
        y, z = cascade(x_ref[t - padlen, cols], z)
        fwd_ref[t, cols] = y
        return z

    def fwd_right(t, z):  # ext[t] = 2 x[L-1] - x[2 (L-1) + padlen - t]
        y, z = cascade(2.0 * xl - x_ref[2 * (L - 1) + padlen - t, cols], z)
        fwd_ref[t, cols] = y
        return z

    first = 2.0 * x0 - x_ref[padlen, cols]
    z = tuple(zi[j] * first for j in range(2 * S))
    z = lax.fori_loop(0, padlen, fwd_left, z)
    z = lax.fori_loop(padlen, padlen + L, fwd_mid, z)
    lax.fori_loop(padlen + L, Lp, fwd_right, z)

    def bwd_tail(t, z):  # right padding: state only
        return cascade(fwd_ref[Lp - 1 - t, cols], z)[1]

    def bwd(t, z):
        rt = Lp - 1 - t
        y, z = cascade(fwd_ref[rt, cols], z)
        y_ref[rt - padlen, cols] = y
        return z

    first_b = fwd_ref[Lp - 1, cols]
    z = lax.fori_loop(0, padlen, bwd_tail,
                      tuple(zi[j] * first_b for j in range(2 * S)))
    lax.fori_loop(padlen, padlen + L, bwd, z)


@partial(jax.jit, static_argnames=("sos", "zi", "padlen", "interpret"))
def _sosfiltfilt_scan_jit(x, sos, zi, padlen, interpret):
    sos_np = np.asarray(sos, np.float64)
    n, L = x.shape
    # float32 conditioning: remove the per-wave mean and add back its exact
    # DC response c * H(1)^2 (zi holds every section in steady state)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    dc_gain = float(np.prod(np.sum(sos_np[:, :3], axis=1)
                            / np.sum(sos_np[:, 3:], axis=1)))
    n_pad = _round_up(n, BLOCK)
    x_T = jnp.pad(x - mean, ((0, n_pad - n), (0, 0))).T
    normalized = tuple(
        (float(r[0] / r[3]), float(r[1] / r[3]), float(r[2] / r[3]),
         float(r[4] / r[3]), float(r[5] / r[3])) for r in sos_np
    )
    kernel = partial(
        _sosfiltfilt_kernel, sos=normalized,
        zi=tuple(float(v) for v in np.asarray(zi).reshape(-1)),
        L=L, padlen=padlen,
    )
    y_T, _ = _pallas(
        kernel, n_pad,
        [jax.ShapeDtypeStruct((L, n_pad), f32),
         jax.ShapeDtypeStruct((L + 2 * padlen, n_pad), f32)],
        interpret, "sosfiltfilt_scan",
    )(x_T)
    return y_T[:, :n].T + mean * (dc_gain * dc_gain)


def sosfiltfilt_scan(waves, sos, interpret: bool = False) -> jax.Array:
    """Zero-phase sosfiltfilt of a (n, L) float32 batch (L > padlen)."""
    from waveformanalysis_tpu.ops.filtering import (
        sosfilt_zi,
        sosfiltfilt_padlen,
    )

    sos = np.asarray(sos, np.float64)
    padlen = sosfiltfilt_padlen(sos)
    if waves.shape[-1] <= padlen:
        raise ValueError(
            f"wave length {waves.shape[-1]} must exceed padlen {padlen}")
    return _sosfiltfilt_scan_jit(
        jnp.asarray(waves, f32), tuple(map(tuple, sos)),
        tuple(map(tuple, sosfilt_zi(sos))), padlen, interpret,
    )
