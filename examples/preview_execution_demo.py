#!/usr/bin/env python
"""preview_execution(): confirm the plan before running anything.

Shows the execution plan, per-stage cache status (memory/disk/miss),
the needed set, and non-default config deltas — with no computation.
After one real get_data the preview reflects the now-valid caches.
(reference analog: examples/demo_preview_execution.py)
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(*default_plugins())
        ctx.set_config({
            "hit": {"height": 120.0, "prominence": 40.0},
            "df_paired": {"time_window_ns": 250.0},
        })
        st = make_fake_st_waveforms(n_events=64, wave_length=64,
                                    n_channels=2, pulse_start=20,
                                    pulse_width=6, pulse_height=250,
                                    noise_rms=2.0, seed=11)
        ctx.inject_data("run_001", "st_waveforms", st)

        # -- 1. basic preview: everything is a miss before the first run ---
        print("=" * 70)
        print("preview BEFORE computing (all stages miss)")
        print("=" * 70)
        result = ctx.preview_execution("run_001", "s1_s2", verbose=True)

        # -- 2. programmatic use -------------------------------------------
        plan = result["plan"]
        misses = [n for n, s in result["cache_status"].items() if s == "miss"]
        print(f"\nplan has {len(plan)} stages; {len(misses)} cold: {misses}")
        print("config deltas:",
              {k: sorted(v) for k, v in result["config_deltas"].items() if v})

        # -- 3. compute once, preview again: caches now valid ---------------
        out = ctx.get_data("run_001", "s1_s2")
        labels = np.asarray(out["label"])
        print(f"\ncomputed s1_s2: {len(out)} rows "
              f"(S1={int(np.sum(labels == 1))}, S2={int(np.sum(labels == 2))})")
        ctx.flush_saves()

        print("\n" + "=" * 70)
        print("preview AFTER computing (stages served from cache)")
        print("=" * 70)
        result2 = ctx.preview_execution("run_001", "s1_s2", verbose=True)
        warm = [n for n, s in result2["cache_status"].items() if s != "miss"]
        print(f"\nwarm stages: {warm}")


if __name__ == "__main__":
    main()
