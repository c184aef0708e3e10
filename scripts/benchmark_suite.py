#!/usr/bin/env python
"""Benchmark suite: the driver BASELINE.json configs (+ extensions).

Each config prints one JSON line {"config", "metric", "value", "unit",
"vs_baseline"}; `--all` runs every config in this process. The repo-root
bench.py times config 4 at full scale.

  1 basic_features on synthetic waveforms (device reductions + f64 combine)
  2 records builder via DAQ adapter (VX2730 decode -> time-sorted records)
  3 filtered-pulse chain (zero-phase IIR -> widths; the platform's
    sosfiltfilt kernel from ops/dispatch.py)
  4 S1/S2 peak-finding + classification (bench.py's plain full chain)
  5 streaming chunked full-run context (dual baseline, breaks, caching)
  6 multi-run batched dispatch vs a per-run loop (dispatch amortization)
  7 Context-routed full S1/S2 cone at headline scale (ONE fused device
    program for hit+features+widths+s1_s2; vs_baseline = plain full chain)

vs_baseline compares against a single-core reference-style NumPy/SciPy
implementation of the same semantics, measured in-process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def _emit(config: int, metric: str, value: float, unit: str, base: float) -> None:
    print(json.dumps({
        "config": config,
        "metric": metric,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / base, 2) if base > 0 else None,
    }))


def _synth_waves(n: int, L: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    centers = rng.integers(40, L - 40, n)
    waves = 1000.0 + 300.0 * np.exp(
        -((t[None, :] - centers[:, None]) ** 2) / (2 * 16.0)
    )
    waves += rng.normal(0, 2, waves.shape)
    return np.round(waves).astype(np.int16)


def config_1(n: int = 65536, L: int = 256) -> None:
    """basic_features throughput (device reductions, exact combine)."""
    import jax
    import jax.numpy as jnp

    from waveformanalysis_tpu.ops.features import feature_reductions

    waves = _synth_waves(n, L)
    wd = jnp.asarray(waves)
    el = jnp.asarray(np.full(n, L, np.int32))
    fn = jax.jit(lambda w, v: feature_reductions(
        w, v, height_start=40, height_end=90, area_start=0, area_end=L))
    jax.block_until_ready(fn(wd, el))
    t0 = time.perf_counter()
    iters = 20
    outs = [fn(wd, el) for _ in range(iters)]
    jax.block_until_ready(outs)
    rate = n * iters / (time.perf_counter() - t0)

    sub = waves[:2000].astype(np.float64)
    t0 = time.perf_counter()
    for w in sub:
        _h = w[40:90].max() - 1000.0
        _a = float(np.sum(w - 1000.0))
        _amp = w[40:90].max() - w[40:90].min()
        _mad = float(np.max(np.abs(np.diff(w))))
    base = len(sub) / (time.perf_counter() - t0)
    _emit(1, "basic_features waveforms/s", rate, "waveforms/s", base)


def config_2(n_events: int = 100000, n_channels: int = 4, L: int = 64) -> None:
    """records builder: VX2730 CSV decode -> time-sorted records + pool."""
    sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
    from utils import create_daq_run

    from waveformanalysis_tpu.processing.loader import get_raw_files
    from waveformanalysis_tpu.processing.records_builder import (
        build_records_from_raw_files,
    )

    with tempfile.TemporaryDirectory() as tmp:
        create_daq_run(Path(tmp), "bench_run", n_channels=n_channels,
                       n_rows=n_events // n_channels, n_samples=L)
        raw = get_raw_files("bench_run", data_root=tmp, daq_adapter="vx2730")
        t0 = time.perf_counter()
        bundle = build_records_from_raw_files(raw, adapter_name="vx2730",
                                              default_dt_ns=2)
        dt = time.perf_counter() - t0
        n = len(bundle.records)
        rate = n / dt

        # reference-style baseline: per-row python decode + heap merge
        import heapq

        t0 = time.perf_counter()
        streams = []
        sample_files = [fl[0] for fl in raw][:n_channels]
        for path in sample_files:
            rows = []
            with open(path) as fh:
                for i, line in enumerate(fh):
                    parts = line.strip().split(";")
                    if len(parts) < 8 or not parts[2].strip().isdigit():
                        continue
                    ts = int(parts[2])
                    wave = [int(float(v)) for v in parts[7:]]
                    bl = sum(wave[:40]) / 40.0  # reference per-row baseline
                    rows.append((ts, int(parts[0]), int(parts[1]), bl, wave))
            streams.append(rows)
        merged = list(heapq.merge(*streams, key=lambda r: r[0]))
        base = len(merged) / (time.perf_counter() - t0)
    _emit(2, "records build+sort records/s", rate, "records/s", base)


def config_3(n: int = 16384, L: int = 256) -> None:
    """filtered-pulse chain: zero-phase bandpass + 10-90% widths."""
    import jax
    import jax.numpy as jnp
    from scipy.signal import sosfiltfilt as scipy_ff

    from waveformanalysis_tpu.ops.dispatch import kernel_for
    from waveformanalysis_tpu.ops.filtering import (
        _sosfiltfilt_device_core,
        design_butterworth_sos,
        sosfilt_zi,
        sosfiltfilt_padlen,
    )
    from waveformanalysis_tpu.ops.scan_kernels import sosfiltfilt_scan
    from waveformanalysis_tpu.ops.widths import width_from_peaks

    waves = _synth_waves(n, L).astype(np.float32)
    sos = design_butterworth_sos(2, 0.1, 0.2, 0.5)
    padlen = sosfiltfilt_padlen(sos)
    use_scan = kernel_for("sosfiltfilt") == "scan"

    wd = jnp.asarray(waves)
    pos = jnp.asarray(np.argmax(waves, axis=1).astype(np.int32))

    @jax.jit
    def step(x, p):
        if use_scan:
            y = sosfiltfilt_scan(x, sos)
        else:
            y = _sosfiltfilt_device_core(
                x, jnp.asarray(sos, jnp.float32),
                jnp.asarray(sosfilt_zi(sos), jnp.float32), padlen)
        return width_from_peaks(y - 1000.0, p)

    jax.block_until_ready(step(wd, pos))
    iters = 10
    t0 = time.perf_counter()
    outs = [step(wd, pos) for _ in range(iters)]
    jax.block_until_ready(outs)
    rate = n * iters / (time.perf_counter() - t0)

    sub = waves[:500].astype(np.float64)
    t0 = time.perf_counter()
    filt = scipy_ff(sos, sub, axis=-1)
    for w in filt:
        p = int(np.argmax(w))
        c = w - np.mean(w[:50])
        pv = c[p]
        if pv > 0:
            lo = np.where(c[:p] >= 0.1 * pv)[0]
            hi = np.where(c[p:] <= 0.1 * pv)[0]
    base = len(sub) / (time.perf_counter() - t0)
    _emit(3, "filtered chain waveforms/s", rate, "waveforms/s", base)


def config_4() -> None:
    """S1/S2 headline (delegates to bench.py semantics at reduced n)."""
    import bench

    bench.N_EVENTS = 32768
    bench.main()


def config_5(n_events: int = 32768, L: int = 128) -> None:
    """streaming chunked full-run: dual baseline + grouping + cache lineage."""
    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.dataframe import DataFramePlugin
    from waveformanalysis_tpu.plugins.builtin.event_analysis import (
        GroupedEventsPlugin,
    )
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

    st = make_fake_st_waveforms(n_events=n_events, wave_length=L,
                                pulse_height=300, polarity="positive")
    st["channel"] = (np.arange(n_events) % 2).astype(np.int16)

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(BasicFeaturesPlugin(), DataFramePlugin(),
                     GroupedEventsPlugin())
        ctx.inject_data("r", "st_waveforms", st)
        t0 = time.perf_counter()
        out = ctx.get_data("r", "df_events")
        dt_cold = time.perf_counter() - t0
        rate = n_events / dt_cold
        assert len(out) > 0
        t0 = time.perf_counter()
        ctx2 = ctx.clone()
        ctx2.inject_data("r", "st_waveforms", st)
        out2 = ctx2.get_data("r", "df_events")
        dt_cached = time.perf_counter() - t0
        assert len(out2) == len(out)
        ctx2.flush_saves()  # async writes settle before the tempdir goes

    # vs_baseline here = lineage-cache payoff: how much faster a cached
    # re-read through a cloned context is than the cold build.
    cached_rate = n_events / dt_cached
    print(json.dumps({
        "config": 5,
        "metric": (
            f"full-run cold events/s (cached re-read {dt_cached * 1e3:.0f} ms)"
        ),
        "value": round(rate, 1),
        "unit": "events/s",
        "vs_baseline": round(cached_rate / rate, 2) if rate else None,
    }))


def config_6(n_events: Optional[int] = None, L: int = 128, n_runs: int = 8) -> None:
    """multi-run batched dispatch vs a per-run loop (same process, warm)."""
    import jax

    if n_events is None:
        # dispatch amortization is the quantity under test; CPU kernels are
        # slow enough that production scale would swamp it in compute time
        n_events = 2048 if jax.default_backend() == "cpu" else 32768

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.dataframe import DataFramePlugin
    from waveformanalysis_tpu.plugins.builtin.event_analysis import (
        GroupedEventsPlugin,
    )
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

    def mkrun(seed):
        st = make_fake_st_waveforms(n_events=n_events, wave_length=L,
                                    pulse_height=300, polarity="positive",
                                    noise_rms=3.0, seed=seed)
        st["channel"] = (np.arange(n_events) % 2).astype(np.int16)
        return st

    def mkctx(tmp, runs):
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(BasicFeaturesPlugin(), DataFramePlugin(),
                     GroupedEventsPlugin())
        for rid, st in runs.items():
            ctx.inject_data(rid, "st_waveforms", st)
        return ctx

    with tempfile.TemporaryDirectory() as tmp:
        # warm both program variants on throwaway runs
        warm = {f"w{i}": mkrun(900 + i) for i in range(n_runs)}
        ctx = mkctx(os.path.join(tmp, "w"), warm)
        ctx.get_data("w0", "df_events")
        ctx.get_data_batched(list(warm), "df_events")
        ctx.flush_saves()

        loop_runs = {f"l{i}": mkrun(100 + i) for i in range(n_runs)}
        ctx_l = mkctx(os.path.join(tmp, "l"), loop_runs)
        t0 = time.perf_counter()
        for rid in loop_runs:
            ctx_l.get_data(rid, "df_events")
        dt_loop = time.perf_counter() - t0
        ctx_l.flush_saves()

        batch_runs = {f"b{i}": mkrun(200 + i) for i in range(n_runs)}
        ctx_b = mkctx(os.path.join(tmp, "b"), batch_runs)
        t0 = time.perf_counter()
        out = ctx_b.get_data_batched(list(batch_runs), "df_events")
        dt_batch = time.perf_counter() - t0
        assert all(len(out[r]) > 0 for r in batch_runs)
        ctx_b.flush_saves()

    total = n_runs * n_events
    print(json.dumps({
        "config": 6,
        "metric": (
            f"batched {n_runs}-run events/s (per-run loop "
            f"{total / dt_loop / 1e3:.0f}k ev/s)"
        ),
        "value": round(total / dt_batch, 1),
        "unit": "events/s",
        "vs_baseline": round(dt_loop / dt_batch, 2),
    }))


def config_7(n: int = 65536, L: int = 256, reps: int = 4) -> None:
    """Context-routed S1/S2 cone: `ctx.get_data(run, "s1_s2")` compiles the
    full hit+basic_features+waveform_width(+s1_s2 host finalize) cone into
    ONE device program (context/fusion.py). Reports warm per-run wall time
    and phase attribution; vs_baseline = plain full chain device time /
    the Context path's device_program time (1.0 = no fusion-layer loss)."""
    import jax
    import jax.numpy as jnp

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.models.full_chain import (
        ChainConfig,
        make_jit_chain,
    )
    from waveformanalysis_tpu.plugins.builtin.basic_features import (
        BasicFeaturesPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.hit_finder import (
        ThresholdHitPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.peak_finding import (
        HitFinderPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.s1_s2_classifier import (
        S1S2ClassifierPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.waveform_width import (
        WaveformWidthPlugin,
    )
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

    def mkrun(i):
        st = make_fake_st_waveforms(
            n_events=n, wave_length=L, pulse_height=300,
            polarity="positive", seed=i,
        )
        st["channel"] = (np.arange(n) % 2).astype(np.int16)
        return st

    per_run = []
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(BasicFeaturesPlugin(), HitFinderPlugin(),
                     ThresholdHitPlugin(), WaveformWidthPlugin(),
                     S1S2ClassifierPlugin())
        ctx.set_config({
            "hit": {"use_filtered": False, "use_derivative": False,
                    "height": 80.0, "prominence": 50.0, "width": 2},
            "s1_s2": {"s1_width_range": (0.0, 30.0),
                      "s2_width_range": (40.0, 10000.0)},
        })

        ctx.inject_data("r0", "st_waveforms", mkrun(0))
        t0 = time.perf_counter()
        ctx.get_data("r0", "s1_s2")
        cold = time.perf_counter() - t0

        for i in range(1, reps + 1):
            rid = f"r{i}"
            ctx.inject_data(rid, "st_waveforms", mkrun(i))
            ctx.profiler.reset()
            t0 = time.perf_counter()
            out = ctx.get_data(rid, "s1_s2")
            per_run.append({
                "wall": time.perf_counter() - t0,
                "phases": {
                    k.split("fusion.single.", 1)[1]: v["total_s"]
                    for k, v in ctx.profiler.stats().items()
                    if k.startswith("fusion.single.")
                },
            })
            assert len(out) == n
        ctx.flush_saves()

    # the plain full chain on the same shapes (block on all outputs); on
    # the CPU backend report the Context numbers alone
    kernel_s = None
    if jax.default_backend() != "cpu":
        cfg = ChainConfig(use_derivative=False, peak_height=80.0,
                          peak_prominence=50.0, peak_width=2.0)
        step = make_jit_chain(cfg)
        el = jnp.asarray(np.full(n, L, np.int32))
        bl = jnp.asarray(np.full(n, 1000.0, np.float32))
        pol = jnp.asarray(np.full(n, 1, np.int8))
        batches = [jnp.asarray(_synth_waves(n, L, seed=s)) for s in range(6)]
        jax.block_until_ready(step(batches[0], el, bl, pol))
        t0 = time.perf_counter()
        outs = [step(w, el, bl, pol) for w in batches]
        jax.block_until_ready(outs)
        kernel_s = (time.perf_counter() - t0) / len(batches)

    walls = sorted(r["wall"] for r in per_run)
    med_wall = walls[len(walls) // 2]
    med = {
        k: sorted(r["phases"].get(k, 0.0) for r in per_run)[reps // 2]
        for k in per_run[0]["phases"]
    }
    dev_s = med.get("device_program", float("nan"))
    phases_ms = {k: round(v * 1e3, 1) for k, v in sorted(med.items())}
    kernel_note = (
        f"; plain chain {kernel_s * 1e3:.1f} ms" if kernel_s else ""
    )
    print(json.dumps({
        "config": 7,
        "metric": (
            f"Context-routed s1_s2 warm wf/s at {n}x{L} "
            f"(cold {cold:.1f} s; median wall {med_wall * 1e3:.0f} ms; "
            f"phases ms {phases_ms}{kernel_note})"
        ),
        "value": round(n / med_wall, 1),
        "unit": "waveforms/s",
        "vs_baseline": (
            round(kernel_s / dev_s, 2) if kernel_s and dev_s else None
        ),
    }))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=[1, 2, 3, 4, 5, 6, 7])
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()
    configs = {1: config_1, 2: config_2, 3: config_3, 4: config_4,
               5: config_5, 6: config_6, 7: config_7}
    if args.all:
        for i in sorted(configs):
            configs[i]()
    elif args.config:
        configs[args.config]()
    else:
        ap.print_help()
        sys.exit(2)


if __name__ == "__main__":
    main()
