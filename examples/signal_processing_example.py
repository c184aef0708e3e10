#!/usr/bin/env python
"""Minimal end-to-end example: synthetic waveforms -> basic features.

(reference analog: examples/signal_processing_example.py — BASELINE config #1)

Run with `python examples/signal_processing_example.py` (uses the GPU when
available; set JAX_PLATFORMS=cpu for a quick local run).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.plugins.builtin.basic_features import BasicFeaturesPlugin
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms


def main() -> None:
    # 1. Synthetic structured waveforms: 1000 events, 256 samples,
    #    negative-going pulses of height 200 over a 1000-ADC baseline.
    st_waveforms = make_fake_st_waveforms(
        n_events=1000, wave_length=256,
        pulse_start=80, pulse_width=12, pulse_height=200,
        noise_rms=3.0,
    )

    # 2. A Context over temporary storage with the features plugin.
    ctx = Context(config={"show_progress": True})
    ctx.register(BasicFeaturesPlugin())
    ctx.set_config({"basic_features": {"height_range": (0, None)}})
    ctx.inject_data("demo_run", "st_waveforms", st_waveforms)

    # 3. One call computes (on device), caches, and returns the features.
    features = ctx.get_data("demo_run", "basic_features")

    heights = np.asarray(features["height"])
    areas = np.asarray(features["area"])
    print(f"events:        {len(features)}")
    print(f"mean height:   {heights.mean():.1f} ADC (expected ~200)")
    print(f"mean area:     {areas.mean():.1f} ADC*samples (expected ~2400)")
    print(f"cache key:     {ctx.key_for('demo_run', 'basic_features')}")

    # 4. A second request is a cache hit (memory, then disk across restarts).
    _ = ctx.get_data("demo_run", "basic_features")
    print(f"cache stats:   {ctx.cache_stats()}")


if __name__ == "__main__":
    main()
