#!/usr/bin/env python
"""Performance regression harness: per-target wall time + peak memory on a
synthetic run, before/after comparison.

Behavioral analog of the reference regression checker
(reference: scripts/performance_regression_check.py:20-130 and
scripts/_quality_common.py:76-140): runs the pipeline on a small synthetic
VX2730 run, records avg/max wall time and tracemalloc peak per target, and
compares against a stored baseline JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

DEFAULT_TARGETS = ["st_waveforms", "records", "basic_features", "df_events"]


def measure(targets, n_channels=2, n_rows=12, n_samples=128, reps=3):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from utils import create_daq_run

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import get_profile

    tmp = Path(tempfile.mkdtemp(prefix="wfa_perf_"))
    create_daq_run(tmp, run_name="perf", n_channels=n_channels,
                   n_rows=n_rows, n_samples=n_samples)

    results = {}
    for target in targets:
        times = []
        peaks = []
        for rep in range(reps):
            ctx = Context(
                storage_dir=str(tmp / f"storage_{target}_{rep}"),
                config={"show_progress": False, "data_root": str(tmp),
                        "daq_adapter": "vx2730"},
            )
            ctx.register(*get_profile("default"))
            tracemalloc.start()
            t0 = time.perf_counter()
            ctx.get_data("perf", target)
            dt = time.perf_counter() - t0
            _, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            times.append(dt)
            peaks.append(peak / 1e6)
        results[target] = {
            "avg_s": round(statistics.mean(times), 4),
            "max_s": round(max(times), 4),
            "peak_mb": round(max(peaks), 2),
        }
    return results


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--targets", default=",".join(DEFAULT_TARGETS))
    p.add_argument("--baseline", default=None,
                   help="Baseline JSON to compare against")
    p.add_argument("--save-baseline", default=None,
                   help="Write results as a new baseline JSON")
    p.add_argument("--tolerance", type=float, default=1.5,
                   help="Fail when avg time exceeds baseline x tolerance")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    results = measure(args.targets.split(","), reps=args.reps)
    for target, r in results.items():
        print(f"{target:<24} avg={r['avg_s']:.4f}s max={r['max_s']:.4f}s "
              f"peak={r['peak_mb']:.2f}MB")

    if args.save_baseline:
        with open(args.save_baseline, "w") as fh:
            json.dump(results, fh, indent=2)
        print(f"baseline saved to {args.save_baseline}")

    if args.baseline:
        with open(args.baseline) as fh:
            baseline = json.load(fh)
        failed = []
        for target, r in results.items():
            base = baseline.get(target)
            if not base:
                continue
            if r["avg_s"] > base["avg_s"] * args.tolerance:
                failed.append(
                    f"{target}: {r['avg_s']:.4f}s > "
                    f"{base['avg_s']:.4f}s x {args.tolerance}"
                )
        if failed:
            print("REGRESSIONS:")
            for line in failed:
                print(" ", line)
            return 1
        print("no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
