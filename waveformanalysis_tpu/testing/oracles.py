"""Host oracles: plain per-event NumPy/SciPy implementations of the device
kernels' contracts, independent of the batched device formulations.

Used by the tests and by chip_smoke.py to hold the GPU kernels and the XLA
formulations to the same reference. Everything here loops over events in
Python and is meant for a few thousand events, not a whole run.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BASELINE_SAMPLES = 50


def peaks_oracle(x, vlen: int, height: float, prominence: float,
                 width: float, distance: int, K: int):
    """scipy find_peaks on one true-length wave, keeping the device's
    fixed capacity: the first K height-passing candidates by position.

    Returns (positions, left_ips, right_ips, prominences, n_candidates)
    of the peaks that pass distance, prominence and width.
    """
    from scipy.signal import find_peaks, peak_prominences, peak_widths

    xv = np.asarray(x[:vlen], np.float64)
    cand = (find_peaks(xv, height=height)[0] if vlen >= 3
            else np.zeros(0, np.int64))
    n_cand = len(cand)
    cand = cand[:K]
    keep = np.ones(len(cand), bool)
    if distance > 1 and len(cand):
        # greedy by height; ties: the later peak first (stable order)
        order = sorted(range(len(cand)), key=lambda i: (xv[cand[i]], i),
                       reverse=True)
        for i in order:
            if keep[i]:
                close = np.abs(cand - cand[i]) < distance
                close[i] = False
                keep &= ~close
    peaks = cand[keep]
    if not len(peaks):
        empty = np.zeros(0)
        return peaks, empty, empty, empty, n_cand
    prom, lb, rb = peak_prominences(xv, peaks)
    w, _, lips, rips = peak_widths(xv, peaks, rel_height=0.5,
                                   prominence_data=(prom, lb, rb))
    ok = (prom >= prominence) & (w >= width)
    return peaks[ok], lips[ok], rips[ok], prom[ok], n_cand


def peaks_slots_oracle(det, det_len, height: float, prominence: float,
                       width: float, distance: int, K: int
                       ) -> Dict[str, np.ndarray]:
    """(n, K) slot tables in the layout of ops.peaks.find_peaks_batch:
    valid peaks first in positional order (the device keeps them in their
    candidate slots, so compare per-event lists, not slot indices)."""
    n = len(det)
    out = {"position": [], "left_ips": [], "right_ips": [],
           "prominence": [], "n_candidates": np.zeros(n, np.int64)}
    for i in range(n):
        p, lip, rip, prom, nc = peaks_oracle(
            det[i], int(det_len[i]), height, prominence, width, distance, K)
        out["position"].append(p)
        out["left_ips"].append(lip)
        out["right_ips"].append(rip)
        out["prominence"].append(prom)
        out["n_candidates"][i] = nc
    return out


def runs_oracle(sig, thr: float, vlen: int, le: int, re: int, K: int
                ) -> Tuple[int, List[Dict[str, float]]]:
    """Threshold runs of one wave: (n_runs, first-K run records).

    A run is a maximal stretch of samples >= thr inside the valid length;
    its segment extends ``le``/``re`` samples, clipped to the padded wave;
    position/height = first argmax of the segment, integral = sum of the
    segment's positive part.
    """
    sig = np.asarray(sig, np.float64)
    L = len(sig)
    on = (sig >= thr) & (np.arange(L) < vlen)
    d = np.diff(np.concatenate([[0], on.astype(int), [0]]))
    starts, ends = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
    runs = []
    for s, e in zip(starts[:K], ends[:K]):
        ss, se = max(s - le, 0), min(e + re, L)
        seg = sig[ss:se]
        runs.append({
            "run_start": int(s), "run_end": int(e),
            "seg_start": int(ss), "seg_end": int(se),
            "position": int(ss + np.argmax(seg)),
            "height": float(seg.max()),
            "integral": float(np.maximum(seg, 0).sum()),
        })
    return len(starts), runs


def corrected(w) -> np.ndarray:
    """Baseline-corrected rows: minus the mean of the first 50 samples."""
    w = np.asarray(w, np.float64)
    nb = min(BASELINE_SAMPLES, w.shape[-1])
    return w - w[..., :nb].mean(axis=-1, keepdims=True)


def width_oracle(corr, p: int, lo: float, hi: float,
                 interpolation: bool = True) -> Dict[str, float]:
    """Crossing widths around position p of one baseline-corrected row:
    rising = first index in [0, p) with corr >= thr, falling = first index
    in [p, L) with corr <= thr, optionally interpolated between samples."""
    L = len(corr)
    pv = corr[p]

    def crossing(thr, rising):
        idx = (np.flatnonzero(corr[:p] >= thr) if rising
               else p + np.flatnonzero(corr[p:] <= thr))
        if not len(idx):
            return None
        i = int(idx[0])
        rel = i if rising else i - p
        if interpolation and rel > 0:
            y0, y1 = corr[i - 1], corr[i]
            if abs(y1 - y0) >= 1e-10:
                return (i - 1) + (thr - y0) / (y1 - y0)
        return float(i)

    r_lo, r_hi = crossing(pv * lo, True), crossing(pv * hi, True)
    f_hi, f_lo = crossing(pv * hi, False), crossing(pv * lo, False)

    def ok(*a):
        return all(v is not None for v in a)

    return {
        "rise_samples": r_hi - r_lo if ok(r_lo, r_hi) else 0.0,
        "fall_samples": f_lo - f_hi if ok(f_hi, f_lo) else 0.0,
        "total_samples": f_lo - r_lo if ok(r_lo, f_lo) else 0.0,
        "peak_height": pv,
        "width_valid": int(0 <= p < L and pv > 0),
    }


def minmax_height(w, lip: float, rip: float, ext: int = 4) -> float:
    """Peak height as max-min of the raw wave over the rounded ips window
    widened by ``ext`` samples (the hit plugin's 'minmax' method)."""
    L = len(w)
    s = int(np.clip(np.round(lip), 0, L - 1))
    f = int(np.clip(np.round(rip), 0, L - 1))
    win = np.asarray(w, np.float64)[max(s - ext, 0):min(f + ext, L)]
    return float(win.max() - win.min()) if len(win) else 0.0


def chain_oracle(waves, el, bl, pol, cfg) -> Dict[str, np.ndarray]:
    """Per-event oracle of models.full_chain.full_chain_step."""
    waves = np.asarray(waves)
    n, L = waves.shape
    keys = ("height", "amp", "area", "max_abs_diff", "peak_position",
            "n_peaks", "n_hits", "hit_integral", "rise_samples",
            "fall_samples", "width_samples", "label")
    out = {k: [] for k in keys}
    n_po = n_ho = 0
    hs, he = cfg.height_range[0], min(cfg.height_range[1], L)
    t = np.arange(L)
    for i in range(n):
        w = waves[i].astype(np.float64)
        e, b, pos = int(el[i]), float(bl[i]), pol[i] > 0
        hw = w[(t < e) & (t >= hs) & (t < he)]
        aw = w[(t < e) & (t >= cfg.area_start)]
        height = amp = area = 0.0
        if len(hw):
            height = hw.max() - b if pos else b - hw.min()
            amp = hw.max() - hw.min()
        if len(aw):
            area = aw.sum() - len(aw) * b if pos else len(aw) * b - aw.sum()
        dif = np.abs(np.diff(w))[: max(e - 1, 0)]
        sign = 1.0 if pos else -1.0
        signal = sign * (w - b)
        if cfg.use_derivative:
            det, det_len = sign * np.diff(w), max(e - 1, 0)
        else:
            det, det_len = signal, e
        peaks, lips, rips, _, n_cand = peaks_oracle(
            det, det_len, cfg.peak_height, cfg.peak_prominence,
            cfg.peak_width, cfg.peak_distance, cfg.max_peaks)
        n_po += n_cand > cfg.max_peaks
        heights = [minmax_height(w, a, c) for a, c in zip(lips, rips)]
        n_runs, runs = runs_oracle(signal, cfg.hit_threshold, e,
                                   cfg.left_extension, cfg.right_extension,
                                   cfg.max_hits)
        n_ho += n_runs > cfg.max_hits
        rise = fall = width = 0.0
        best = -1
        if len(peaks):
            best = int(peaks[int(np.argmax(heights))])
            wd = width_oracle(corrected(signal), best, cfg.rise_low,
                              cfg.rise_high)
            rise, fall = wd["rise_samples"], wd["fall_samples"]
            width = wd["total_samples"] if wd["width_valid"] else 0.0
        label = 0
        if best >= 0 and width > 0:
            label = (1 if width <= cfg.s1_width_max
                     else 2 if width >= cfg.s2_width_min else 0)
        for k, v in (
            ("height", height), ("amp", amp), ("area", area),
            ("max_abs_diff", dif.max() if len(dif) else 0.0),
            ("peak_position", best), ("n_peaks", len(peaks)),
            ("n_hits", len(runs)),
            ("hit_integral", sum(r["integral"] for r in runs)),
            ("rise_samples", rise), ("fall_samples", fall),
            ("width_samples", width), ("label", label),
        ):
            out[k].append(v)
    res = {k: np.asarray(v) for k, v in out.items()}
    res["n_peak_overflow"] = np.int32(n_po)
    res["n_hit_overflow"] = np.int32(n_ho)
    return res
