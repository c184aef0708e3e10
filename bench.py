"""Benchmark: the plain full chain's throughput on one device.

Times the jitted records->features->peaks->threshold-hits->widths->S1/S2
chain (models/full_chain.py, the XLA formulations) on a resident
65,536 x 256 batch, and a reference-style per-event CPU loop (scipy
find_peaks, basic_features.py:224 / peak_finding.py:446) measured live on
this host. The device path refuses to run without an accelerator.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_cpu_live", "device", ...}.
The benchmark with cells and per-layer metrics is not this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import numpy as np

N_EVENTS = 65_536
WAVE_LEN = 256
ROUNDS = 5
ITERS = 6


def make_batch(n_events: int, wave_length: int, seed: int = 0) -> np.ndarray:
    """Mixed narrow/wide positive pulses on a 1000-ADC baseline."""
    rng = np.random.default_rng(seed)
    t = np.arange(wave_length)
    centers = rng.integers(60, wave_length - 60, n_events)
    sigmas = np.where(np.arange(n_events) % 2 == 0, 3.0, 25.0)
    amps = np.where(np.arange(n_events) % 2 == 0, 400.0, 250.0)
    waves = 1000.0 + amps[:, None] * np.exp(
        -((t[None, :] - centers[:, None]) ** 2) / (2 * sigmas[:, None] ** 2)
    )
    waves += rng.normal(0, 2, waves.shape)
    return np.round(waves).astype(np.int16)


def cpu_reference_rate(waves: np.ndarray, n_sample: int = 300) -> float:
    """Reference-style per-event loop: features + scipy find_peaks + widths
    + classification. Returns events/sec on one core (best of 3)."""
    sub = waves[:n_sample].astype(np.float64)
    return max(_cpu_loop_once(sub) for _ in range(3))


def _cpu_loop_once(sub: np.ndarray) -> float:
    from scipy.signal import find_peaks

    t0 = time.perf_counter()
    for wave in sub:
        b = 1000.0
        # basic features
        wp = wave[40:90]
        if wp.size:
            _height = wave.max() - b
            _amp = wp.max() - wp.min()
        _area = float(np.sum(wave - b))
        _mad = float(np.max(np.abs(np.diff(wave))))
        # peak finding on the normalized signal
        signal = wave - b
        pos, props = find_peaks(signal, height=80.0, distance=2,
                                prominence=50.0, width=2)
        # threshold hit runs
        above = signal > 10.0
        _n_hits = int(np.sum(above[1:] & ~above[:-1]) + above[0])
        # width + classification on the dominant peak
        if len(pos):
            p = pos[np.argmax(signal[pos])]
            peak_value = signal[p]
            lo = np.where(signal[:p] >= 0.1 * peak_value)[0]
            hi = np.where(signal[p:] <= 0.1 * peak_value)[0]
            if len(lo) and len(hi):
                width = (p + hi[0]) - lo[0]
                _label = 1 if width <= 30 else (2 if width >= 40 else 0)
    dt = time.perf_counter() - t0
    return len(sub) / dt


def device_rounds() -> list:
    """Per-round rates (events/s) of the jitted chain; every iteration of a
    round gets its own batch, all made and uploaded before timing."""
    import jax
    import jax.numpy as jnp

    from waveformanalysis_tpu.models.full_chain import (
        ChainConfig,
        make_jit_chain,
    )

    cfg = ChainConfig(use_derivative=False, peak_height=80.0,
                      peak_prominence=50.0, peak_width=2.0)
    step = make_jit_chain(cfg)
    el = jnp.full((N_EVENTS,), WAVE_LEN, jnp.int32)
    bl = jnp.full((N_EVENTS,), 1000.0, jnp.float32)
    pol = jnp.ones((N_EVENTS,), jnp.int8)
    batches = [jnp.asarray(make_batch(N_EVENTS, WAVE_LEN, seed=s))
               for s in range(ITERS)]
    jax.block_until_ready(step(batches[0], el, bl, pol))  # compile
    rounds = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        outs = [step(w, el, bl, pol) for w in batches]
        jax.block_until_ready(outs)
        rounds.append(N_EVENTS * ITERS / (time.perf_counter() - t0))
    return rounds


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py: no accelerator; device rates are not measured on "
              "the CPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rounds = device_rounds()
    rate = statistics.median(rounds)
    cpu_live = cpu_reference_rate(make_batch(N_EVENTS, WAVE_LEN))
    print(json.dumps({
        "metric": ("events_per_sec (plain full chain: features+find_peaks+"
                   f"hits+widths+S1/S2, {WAVE_LEN} samples/event, "
                   "resident batch)"),
        "value": round(rate, 1),
        "unit": "events/s",
        "vs_cpu_live": round(rate / cpu_live, 2),
        "cpu_rate_live": round(cpu_live, 1),
        "rounds": [round(r, 1) for r in rounds],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
