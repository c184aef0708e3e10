#!/usr/bin/env python
"""Hand-written GPU kernels against the XLA formulations, on the card.

For each op with a hand kernel (ops/scan_kernels.py) this checks the kernel
against the XLA formulation and times both at one shape (default
65,536 events x 256 samples, full and ragged valid lengths), then times the
Context path end to end with each choice (``ctx.get_data`` on fresh run
ids, parent/change order xla, scan, scan, xla). It also reports whether the
XLA associative-scan IIR compiles at that shape, and a profile of the fused
s1_s2 program (device kernels by total time).

    python scripts/bench_kernels.py [--n 65536] [--L 256] [--reps 20]
                                    [--out-dir bench_out]

Needs a GPU; prints the card's name and power limit beside the numbers and
writes everything to <out-dir>/bench_kernels.json (profiles to
<out-dir>/trace_*).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def timeit(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def same(a, b, atol):
    import numpy as np

    bad = []
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        ok = (np.array_equal(x, y) if x.dtype.kind in "biu"
              else np.allclose(x, y, atol=atol, rtol=1e-5))
        if not ok:
            bad.append(k)
    return bad


def wave_readers(fn, args, n, L):
    """Kernels of the compiled program that take an (n, L) operand: the
    number of passes over the wave matrix (loop bodies count once)."""
    import re

    text = fn.lower(*args).compile().as_text()
    inst = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+) = (\S+?)(?:\{[^}]*\})? "
                      r"([\w\-]+)\((.*?)\)")
    shapes, kernels = {}, []
    for line in text.splitlines():
        m = inst.match(line)
        if not m:
            continue
        name, shape, op, operands = m.groups()
        shapes[name] = shape
        if op in ("fusion", "custom-call"):
            kernels.append(re.findall(r"%[\w.\-]+", operands))
    wave = f"[{n},{L}]"
    return sum(any(wave in shapes.get(o, "") for o in ops) for ops in kernels)


def kernel_rows(n, L, reps, seed):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from waveformanalysis_tpu.ops.filtering import (
        _sosfiltfilt_device_core,
        design_butterworth_sos,
        sosfilt_zi,
        sosfiltfilt_padlen,
    )
    from waveformanalysis_tpu.ops.hits import threshold_hits_batch
    from waveformanalysis_tpu.ops.peaks import find_peaks_batch
    from waveformanalysis_tpu.ops.scan_kernels import (
        find_peaks_scan,
        sosfiltfilt_scan,
        threshold_hits_scan,
    )
    from waveformanalysis_tpu.ops.widths import width_from_peak_slots
    from waveformanalysis_tpu.testing.fixtures import make_pulse_waves

    rng = np.random.default_rng(seed)
    w = jnp.asarray(make_pulse_waves(n, L, seed=seed))
    w32 = w.astype(jnp.float32)
    full = jnp.full((n,), L, jnp.int32)
    ragged = jnp.asarray(rng.integers(L // 2, L + 1, n).astype(np.int32))
    det = -(w32[:, 1:] - w32[:, :-1])
    sig = -(w32 - 8000.0)
    thr = jnp.full((n,), 10.0, jnp.float32)
    pk = dict(height=30.0, prominence=0.7, width=4.0, distance=2,
              max_peaks=32)
    rows = []
    for tag, vl in (("full", full), ("ragged", ragged)):
        dl = jnp.maximum(vl - 1, 0)
        xla = lambda: find_peaks_batch(det, valid_length=dl, **pk)  # noqa
        scan = lambda: find_peaks_scan(det, valid_length=dl, **pk)  # noqa
        rows.append({"op": "find_peaks", "lengths": tag,
                     "mismatch": same(xla(), scan(), 1e-3),
                     "xla_ms": timeit(xla, reps),
                     "scan_ms": timeit(scan, reps)})
        xla = lambda: threshold_hits_batch(sig, thr, vl, max_hits=32)  # noqa
        scan = lambda: threshold_hits_scan(sig, thr, vl, max_hits=32)  # noqa
        rows.append({"op": "threshold_hits", "lengths": tag,
                     "mismatch": same(xla(), scan(), 1e-3),
                     "xla_ms": timeit(xla, reps),
                     "scan_ms": timeit(scan, reps)})
        print(rows[-2], rows[-1], flush=True)

    peaks = find_peaks_batch(det, valid_length=full - 1, **pk)
    width = jax.jit(lambda w_, p, v: width_from_peak_slots(w_, p, v))
    wargs = (sig, peaks["position"], peaks["valid"])
    rows.append({"op": "width_from_peak_slots (K=32)", "lengths": "full",
                 "xla_ms": timeit(lambda: width(*wargs), reps),
                 "valid_slots": int(np.asarray(peaks["valid"]).sum()),
                 "kernels_reading_waves": wave_readers(width, wargs, n, L)})
    print(rows[-1], flush=True)

    sos = design_butterworth_sos(4, 0.02, 0.2, 0.5)
    x = sig
    scan = lambda: sosfiltfilt_scan(x, sos)  # noqa: E731
    row = {"op": "sosfiltfilt (order 4)", "lengths": "full",
           "scan_ms": timeit(scan, reps)}
    core = jax.jit(_sosfiltfilt_device_core, static_argnames=("padlen",))
    args = (x, jnp.asarray(sos, jnp.float32),
            jnp.asarray(sosfilt_zi(sos), jnp.float32),
            sosfiltfilt_padlen(sos))
    try:
        t0 = time.perf_counter()
        ref = core(*args[:3], padlen=args[3])
        jax.block_until_ready(ref)
        row["xla_first_call_s"] = time.perf_counter() - t0
        row["xla_ms"] = timeit(lambda: core(*args[:3], padlen=args[3]), reps)
        a, b = np.asarray(ref), np.asarray(scan())
        row["max_rel_diff"] = float(np.abs(a - b).max() / np.abs(a).max())
    except Exception as exc:  # the measurement reports it; not a fallback
        row["xla_error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
    rows.append(row)
    print(row, flush=True)
    return rows


def e2e_rows(n, L, reps, seed):
    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
    from waveformanalysis_tpu.testing.fixtures import (
        make_fake_st_waveforms,
        make_pulse_waves,
    )

    st = make_fake_st_waveforms(n_events=n, wave_length=L, n_channels=16,
                                baseline=8000.0, polarity="negative")
    st["wave"] = make_pulse_waves(n, L, seed=seed)
    # target, (plugin, option naming the kernel), other config
    cases = {
        "s1_s2": ("s1_s2", ("hit", "peaks_backend"), {}),
        "hit_threshold": ("hit_threshold",
                          ("hit_threshold", "hits_backend"), {}),
        "filtered_waveforms (BW)": (
            "filtered_waveforms", ("filtered_waveforms", "filter_backend"),
            {"filtered_waveforms": {"filter_type": "BW", "lowcut": 0.02,
                                    "highcut": 0.2, "fs": 0.5}}),
    }
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (target, knob, extra) in cases.items():
            times = {"xla": [], "scan": []}
            error = None
            for i, backend in enumerate(
                    ["xla", "scan"] + ["scan", "xla"] * (reps // 2)):
                cfg = {p: dict(v) for p, v in extra.items()}
                cfg.setdefault(knob[0], {})[knob[1]] = backend
                ctx = Context(storage_dir=os.path.join(tmp, f"{name}{i}"),
                              config={"show_progress": False})
                ctx.register(*default_plugins())
                ctx.set_config(cfg)
                run = f"run{i}"
                ctx.inject_data(run, "st_waveforms", st)
                t0 = time.perf_counter()
                try:
                    ctx.get_data(run, target)
                except Exception as exc:
                    error = f"{backend}: {type(exc).__name__}: {str(exc)[:300]}"
                    break
                dt = (time.perf_counter() - t0) * 1e3
                if i >= 2:  # the first pair compiles
                    times[backend].append(dt)
                ctx.flush_saves()
            row = {"e2e": name, "target": target, "error": error,
                   "pairs_scan_faster": sum(
                       s < x for s, x in zip(times["scan"], times["xla"])),
                   "pairs": min(len(times["scan"]), len(times["xla"]))}
            for b, v in times.items():
                if v:
                    row[f"{b}_ms_median"] = statistics.median(v)
                    row[f"{b}_ms_min"] = min(v)
                    row[f"{b}_ms_all"] = v
            rows.append(row)
            print(row, flush=True)
    return rows


def profile_s1_s2(n, L, seed, out_dir):
    """Device kernels of one warm s1_s2 compute (default kernel choice),
    by total device time."""
    import jax

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
    from waveformanalysis_tpu.testing.fixtures import (
        make_fake_st_waveforms,
        make_pulse_waves,
    )

    st = make_fake_st_waveforms(n_events=n, wave_length=L, n_channels=16,
                                baseline=8000.0, polarity="negative")
    st["wave"] = make_pulse_waves(n, L, seed=seed)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, backend in enumerate(("xla", "scan", "xla", "scan")):
            ctx = Context(storage_dir=os.path.join(tmp, str(i)),
                          config={"show_progress": False})
            ctx.register(*default_plugins())
            ctx.set_config({"hit": {"peaks_backend": backend}})
            ctx.inject_data(f"r{i}", "st_waveforms", st)
            trace_dir = os.path.join(out_dir, f"trace_{backend}")
            if i < 2:
                ctx.get_data(f"r{i}", "s1_s2")   # compile
                continue
            with jax.profiler.trace(trace_dir):
                ctx.get_data(f"r{i}", "s1_s2")
            result[backend] = summarize_trace(trace_dir)
            print(backend, json.dumps(result[backend])[:2000], flush=True)
    return result


def summarize_trace(trace_dir, top=25):
    """Sum device-event durations by name from the newest .xplane.pb."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = ProfileData.from_file(path)
    by_name, busy = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.duration_ns
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    union, end = 0.0, None
    for s, e in busy:
        if end is None or s > end:
            union += e - s
            end = e
        elif e > end:
            union += e - end
            end = e
    window = (busy[-1][1] - busy[0][0]) if busy else 0.0
    items = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "device_busy_ms": union / 1e6,
        "device_window_ms": window / 1e6,
        "n_kernel_names": len(items),
        "top_ms": [(k, v / 1e6) for k, v in items[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--L", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--e2e-reps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip", default="", help="comma list: kernels,e2e,trace")
    ap.add_argument("--out-dir", default=str(ROOT / "bench_out"))
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("no GPU: these are device measurements", file=sys.stderr)
        return 1
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    skip = set(filter(None, args.skip.split(",")))
    report = {"card": card(), "device_kind": jax.devices()[0].device_kind,
              "jax": jax.__version__, "n": args.n, "L": args.L}
    print(report, flush=True)
    if "kernels" not in skip:
        report["kernels"] = kernel_rows(args.n, args.L, args.reps, args.seed)
    if "e2e" not in skip:
        report["e2e"] = e2e_rows(args.n, args.L, args.e2e_reps, args.seed)
    if "trace" not in skip:
        report["trace"] = profile_s1_s2(args.n, args.L, args.seed,
                                        str(out_dir))
    (out_dir / "bench_kernels.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
