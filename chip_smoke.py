#!/usr/bin/env python
"""Smoke test: the system's main path on one GPU, end to end.

    python chip_smoke.py [--seed 0]          # one card
    python chip_smoke.py --cards 4           # the mesh path only, 4 cards

One card, in order:

1. device   — JAX must see a GPU (else exit 1, never continue on the CPU);
              prints the card's name and power limit, the JAX version,
              XLA_FLAGS and the compile cache directory.
2. kernels  — at 65,536 events x 256 samples (full and ragged lengths):
              each GPU kernel (ops/scan_kernels.py) and each plain XLA
              formulation against the host oracles
              (waveformanalysis_tpu/testing/oracles.py, scipy.signal);
              then the ``gpu``-marked tests, in this process.
3. cli      — a synthetic VX2730 run at the reference's chunk scale
              (16 channels x 32,768 records x 256 samples) written to disk
              and processed by ``waveform-process`` (cli.main) through
              records -> filtered_waveforms -> hit -> waveform_width ->
              s1_s2 -> events/event_hits (device grouping) -> df_paired
              (when pandas is installed); 8,192+ records checked field by
              field against the host oracles; a second run shows the cache
              hit.
4. fused    — ``ctx.get_data(run, "s1_s2")`` on 65,536 x 256 st_waveforms
              with the platform's kernel choice against ``xla``.

No phase's failure is caught: any failure exits non-zero before the result
line. The last line of output is the JSON result
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N, L = 65536, 256
CHANNELS, RECORDS = 16, 32768
N_ORACLE = 4096      # events per kernel check held to the per-event oracle
N_CHECK = 8192       # records of the CLI run checked field by field
MESH_EVENTS = 131072  # events per card on the mesh path


def log(msg: str = "") -> None:
    print(msg, flush=True)


def exact(name, got, ref) -> None:
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, f"{name}: shape {got.shape} vs {ref.shape}"
    np.testing.assert_array_equal(got, ref, err_msg=name)
    log(f"  {name}: exact ({ref.size} values)")


def close(name, got, ref, atol, rtol, reason) -> None:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{name}: shape {got.shape} vs {ref.shape}"
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=name)
    diff = float(np.max(np.abs(got - ref))) if got.size else 0.0
    log(f"  {name}: max |diff| {diff:.3g} <= atol {atol:g} + rtol {rtol:g}"
        f" ({reason})")


def have_pandas() -> bool:
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    return True


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device(cards: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); nothing is measured on the CPU",
              file=sys.stderr)
        sys.exit(1)
    if len(devices) < cards:
        print(f"chip_smoke: {cards} cards asked, JAX sees {len(devices)}",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from waveformanalysis_tpu.foundation.compile_cache import (
        ensure_compilation_cache,
    )

    cache = ensure_compilation_cache()
    log("== device")
    for line in smi.splitlines():
        log(line)
    log(f"jax {jax.__version__}; devices: {len(devices)} x "
        f"{devices[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    return devices


# --------------------------------------------------------------------------
# 2. kernels against the references
# --------------------------------------------------------------------------

def check_peaks(tag, dev, det, det_len, pk, n_oracle):
    import numpy as np

    from waveformanalysis_tpu.testing.oracles import peaks_slots_oracle

    valid = np.asarray(dev["valid"])
    pos = np.asarray(dev["position"])
    lips, rips = np.asarray(dev["left_ips"]), np.asarray(dev["right_ips"])
    ref = peaks_slots_oracle(det[:n_oracle], det_len[:n_oracle],
                             pk["height"], pk["prominence"], pk["width"],
                             pk["distance"], pk["max_peaks"])
    exact(f"{tag} n_candidates vs scipy", np.asarray(
        dev["n_candidates"])[:n_oracle], ref["n_candidates"])
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0)  # noqa: E731
    sel = [valid[i] for i in range(n_oracle)]
    exact(f"{tag} peak positions vs scipy",
          cat([pos[i][s] for i, s in enumerate(sel)]), cat(ref["position"]))
    for key, got in (("left_ips", lips), ("right_ips", rips)):
        close(f"{tag} {key} vs scipy",
              cat([got[i][s] for i, s in enumerate(sel)]), cat(ref[key]),
              1e-3, 1e-5, "float32 interpolation vs scipy float64")


def check_runs(tag, dev, sig, thr, vlen, kw, n_oracle):
    import numpy as np

    from waveformanalysis_tpu.testing.oracles import runs_oracle

    d = {k: np.asarray(v) for k, v in dev.items()}
    got = {k: [] for k in ("run_start", "run_end", "seg_start", "seg_end",
                           "position", "height", "integral")}
    ref = {k: [] for k in got}
    n_runs = []
    for i in range(n_oracle):
        nr, runs = runs_oracle(sig[i], thr[i], vlen[i], kw["left_extension"],
                               kw["right_extension"], kw["max_hits"])
        n_runs.append(nr)
        assert d["valid"][i].sum() == len(runs), f"{tag} run count, event {i}"
        for k in got:
            got[k].extend(d[k][i][:len(runs)])
            ref[k].extend(r[k] for r in runs)
    exact(f"{tag} n_runs vs host", d["n_runs"][:n_oracle], n_runs)
    for k in ("run_start", "run_end", "seg_start", "seg_end", "position"):
        exact(f"{tag} {k} vs host", got[k], ref[k])
    exact(f"{tag} height vs host", np.asarray(got["height"], np.float64),
          ref["height"])
    close(f"{tag} integral vs host", got["integral"], ref["integral"],
          1e-3, 1e-5, "float32 sum in time order vs float64")


def compare_outputs(tag, a, b, atol, reason):
    import numpy as np

    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype.kind in "biu":
            exact(f"{tag} {k}", y, x)
        else:
            close(f"{tag} {k}", y, x, atol, 1e-5, reason)


def phase_kernels(seed: int, n: int = N, wave_length: int = L,
                  n_oracle: int = N_ORACLE) -> None:
    import numpy as np
    import jax.numpy as jnp

    from waveformanalysis_tpu.ops.filtering import (
        design_butterworth_sos,
        savgol_device,
        savgol_scipy,
        sosfiltfilt_device,
        sosfiltfilt_scipy,
    )
    from waveformanalysis_tpu.ops.hits import threshold_hits_batch
    from waveformanalysis_tpu.ops.peaks import find_peaks_batch
    from waveformanalysis_tpu.ops.scan_kernels import (
        find_peaks_scan,
        threshold_hits_scan,
    )
    from waveformanalysis_tpu.ops.widths import width_from_peak_slots
    from waveformanalysis_tpu.testing.fixtures import make_pulse_waves
    from waveformanalysis_tpu.testing.oracles import corrected, width_oracle

    log(f"== kernels: {n} events x {wave_length} samples")
    t0 = time.perf_counter()
    waves = make_pulse_waves(n, wave_length, seed=seed)  # negative pulses
    rng = np.random.default_rng(seed + 1)
    w = waves.astype(np.float32)
    det = -(w[:, 1:] - w[:, :-1])      # polarity-normalized derivative
    sig = -(w - 8000.0)                # polarity-normalized signal
    det_d, sig_d = jnp.asarray(det), jnp.asarray(sig)
    # hit / hit_threshold plugin defaults
    pk = dict(height=30.0, prominence=0.7, width=4.0, distance=2,
              max_peaks=32)
    hk = dict(left_extension=2, right_extension=2, max_hits=32)
    thr = np.full(n, 10.0, np.float32)
    lengths = {"full": np.full(n, wave_length, np.int32),
               "ragged": rng.integers(wave_length // 2, wave_length + 1,
                                      n).astype(np.int32)}
    for tag, vlen in lengths.items():
        det_len = np.maximum(vlen - 1, 0)
        xla = find_peaks_batch(det_d, valid_length=jnp.asarray(det_len),
                               **pk)
        scan = find_peaks_scan(det_d, valid_length=jnp.asarray(det_len),
                               **pk)
        compare_outputs(f"find_peaks[{tag}] gpu kernel vs xla", xla, scan,
                        1e-3, "float32 interpolation, FMA contraction")
        check_peaks(f"find_peaks[{tag}] xla", xla, det, det_len, pk,
                    n_oracle)
        check_peaks(f"find_peaks[{tag}] gpu kernel", scan, det, det_len, pk,
                    n_oracle)

        args = (sig_d, jnp.asarray(thr), jnp.asarray(vlen))
        xla_h = threshold_hits_batch(*args, **hk)
        scan_h = threshold_hits_scan(*args, **hk)
        compare_outputs(f"threshold_hits[{tag}] gpu kernel vs xla", xla_h,
                        scan_h, 1e-2, "float32 integral: time-order vs tree "
                        "sum over up to ~150 samples of <= 2000 ADC")
        check_runs(f"threshold_hits[{tag}] xla", xla_h, sig, thr, vlen, hk,
                   n_oracle)
        check_runs(f"threshold_hits[{tag}] gpu kernel", scan_h, sig, thr,
                   vlen, hk, n_oracle)

        if tag == "full":
            wd = {k: np.asarray(v) for k, v in width_from_peak_slots(
                sig_d, xla["position"], xla["valid"]).items()}
            corr = corrected(sig[:n_oracle])
            got, ref = [], []
            for i, k in zip(*np.nonzero(wd["valid"][:n_oracle])):
                r = width_oracle(corr[i], int(wd["position"][i, k]),
                                 0.1, 0.9)
                assert wd["width_valid"][i, k] == r["width_valid"], (i, k)
                got.append([wd[f][i, k] for f in ("rise_samples",
                            "fall_samples", "total_samples")])
                ref.append([r[f] for f in ("rise_samples", "fall_samples",
                            "total_samples")])
            close("width_from_peak_slots (xla) vs host", got, ref, 2e-3,
                  1e-5, "float32 baseline mean and interpolation")

    sos = design_butterworth_sos(4, 0.02, 0.2, 0.5)
    ref = sosfiltfilt_scipy(sig, sos)
    scale = float(np.abs(ref).max())
    for backend in ("scan", "xla"):
        got = sosfiltfilt_device(sig, sos, backend=backend)
        close(f"sosfiltfilt ({backend}) vs scipy", got / scale, ref / scale,
              5e-4, 0, "float32 order-4 IIR cascade vs float64, relative "
              "to the signal's peak")
    got = savgol_device(waves, 11, 2)
    close("savgol (xla, HIGHEST) vs scipy", got, savgol_scipy(waves, 11, 2),
          2e-2, 0, "float32 11-tap sums of values ~8000: ~11 ulp of 8000")
    log(f"kernels ok ({time.perf_counter() - t0:.1f} s)")


GPU_TEST_FILES = ("tests/test_scan_kernels.py",)


def phase_gpu_tests() -> None:
    """The ``gpu``-marked tests, run by pytest inside this process (a
    second JAX process could not open the card)."""
    import pytest

    class Tally:
        passed, skipped = 0, 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.skipped:
                self.skipped += 1

    log("== gpu-marked tests")
    os.environ["WFA_TEST_PLATFORM"] = "gpu"
    tally = Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      *(str(ROOT / f) for f in GPU_TEST_FILES)],
                     plugins=[tally])
    assert rc == 0, f"gpu-marked tests: pytest exit code {rc}"
    assert tally.passed > 0 and tally.skipped == 0, \
        f"gpu-marked tests: {tally.passed} passed, {tally.skipped} skipped"
    log(f"gpu-marked tests ok: {tally.passed} passed")


# --------------------------------------------------------------------------
# 3. the CLI end to end over a VX2730 run on disk
# --------------------------------------------------------------------------

def cli_targets():
    targets = ["s1_s2", "event_hits"]
    return targets + (["df_paired"] if have_pandas() else [])


def check_cli_outputs(root, run, waves, config, n_check):
    """Hold the CLI's cached tables to the host oracles on the first
    n_check records of every channel-ordered stream."""
    import numpy as np

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.ops.filtering import savgol_scipy
    from waveformanalysis_tpu.plugins.builtin.peak_finding import (
        _load_wave_matrix,
    )
    from waveformanalysis_tpu.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu.testing.oracles import (
        minmax_height,
        peaks_oracle,
        runs_oracle,
    )

    ctx = Context(storage_dir=os.path.join(root, "_storage"),
                  config=dict(config, data_root=root, daq_adapter="vx2730"))
    ctx.register(*get_profile("default"))
    plugins = ctx.plugins

    # decoded records: samples exactly as written
    raw, lengths, meta = _load_wave_matrix(ctx, plugins["hit_threshold"], run)
    assert len(raw) == waves.shape[0] * waves.shape[1], "record count"
    idx = np.arange(min(n_check, len(raw)))
    ch = meta["channel"][idx].astype(np.int64)
    row = (meta["timestamp"][idx] - ch * 1000) // 10_000_000
    exact("st_waveforms wave vs written samples", raw[idx],
          waves[ch, row].astype(np.float32))
    exact("st_waveforms event_length", lengths[idx],
          np.full(len(idx), waves.shape[2]))

    # filtered waves: Savitzky-Golay (plugin default 11/2) vs scipy
    filt, flen, fmeta = _load_wave_matrix(ctx, plugins["hit"], run)
    exact("filtered_waveforms record order", fmeta["record_id"][idx],
          meta["record_id"][idx])
    close("filtered_waveforms vs scipy savgol_filter", filt[idx],
          savgol_scipy(raw[idx], 11, 2), 2e-2, 0,
          "float32 11-tap sums of values ~8000")

    # hit: scipy find_peaks on the polarity-normalized derivative of the
    # filtered wave, hit plugin defaults
    cfg = plugins["hit"].kernel_config(ctx)
    hit = ctx.get_data(run, "hit")
    by_rec = {}
    rid = np.asarray(hit["record_id"])
    order = np.argsort(rid, kind="stable")
    bounds = np.searchsorted(rid[order], fmeta["record_id"][idx])
    ends = np.searchsorted(rid[order], fmeta["record_id"][idx], side="right")
    got = {k: [] for k in ("position", "edge_start", "edge_end", "height")}
    ref = {k: [] for k in got}
    for j, i in enumerate(idx):
        sign = 1.0 if fmeta["polarity"][i] > 0 else -1.0
        x = filt[i].astype(np.float64)
        det = sign * np.diff(x)
        p, lip, rip, _, _ = peaks_oracle(
            det, int(flen[i]) - 1, cfg["height"], cfg["prominence"],
            cfg["width"], cfg["distance"], cfg["max_peaks"])
        rows = order[bounds[j]:ends[j]]
        assert len(rows) == len(p), f"hit count of record {i}"
        got["position"].extend(np.asarray(hit["position"])[rows])
        got["edge_start"].extend(np.asarray(hit["edge_start"])[rows])
        got["edge_end"].extend(np.asarray(hit["edge_end"])[rows])
        got["height"].extend(np.asarray(hit["height"])[rows])
        ref["position"].extend(p)
        ref["edge_start"].extend(lip)
        ref["edge_end"].extend(rip)
        ref["height"].extend(minmax_height(x, a, b)
                             for a, b in zip(lip, rip))
        by_rec[i] = len(p)
    exact("hit position vs scipy", got["position"], ref["position"])
    for k in ("edge_start", "edge_end", "height"):
        close(f"hit {k} vs scipy", got[k], ref[k], 2e-2, 1e-5,
              "float32 filtered wave and interpolation vs float64")

    # hit_threshold: threshold runs of the raw polarity-normalized signal
    tcfg = plugins["hit_threshold"].kernel_config(ctx)
    th = ctx.get_data(run, "hit_threshold")
    rid = np.asarray(th["record_id"])
    order = np.argsort(rid, kind="stable")
    bounds = np.searchsorted(rid[order], meta["record_id"][idx])
    ends = np.searchsorted(rid[order], meta["record_id"][idx], side="right")
    got = {k: [] for k in ("position", "height", "integral", "edge_start",
                           "edge_end")}
    ref = {k: [] for k in got}
    for j, i in enumerate(idx):
        sign = 1.0 if meta["polarity"][i] > 0 else -1.0
        s = (sign * (raw[i].astype(np.float64)
                     - np.float32(meta["baseline"][i]))).astype(np.float32)
        _, runs = runs_oracle(s, tcfg["threshold"], int(lengths[i]),
                              tcfg["left_extension"],
                              tcfg["right_extension"], tcfg["max_hits"])
        rows = order[bounds[j]:ends[j]]
        assert len(rows) == len(runs), f"hit_threshold count of record {i}"
        for k, rk in (("position", "position"), ("height", "height"),
                      ("integral", "integral"), ("edge_start", "seg_start"),
                      ("edge_end", "seg_end")):
            got[k].extend(np.asarray(th[k])[rows])
            ref[k].extend(r[rk] for r in runs)
    for k in ("position", "edge_start", "edge_end"):
        exact(f"hit_threshold {k} vs host", got[k], ref[k])
    close("hit_threshold height vs host", got["height"], ref["height"],
          1e-3, 1e-6, "float32 signal")
    close("hit_threshold integral vs host", got["integral"],
          ref["integral"], 1e-2, 1e-5, "float32 sums vs float64")
    n_hits = sum(by_rec.values())
    log(f"  checked {len(idx)} records, {n_hits} hits, "
        f"{len(got['position'])} threshold hits")


def phase_cli(seed: int, channels: int = CHANNELS, records: int = RECORDS,
              wave_length: int = L, n_check: int = N_CHECK) -> None:
    import numpy as np

    from waveformanalysis_tpu import cli
    from waveformanalysis_tpu.testing.fixtures import (
        make_pulse_waves,
        make_synthetic_vx2730_run,
    )

    log(f"== cli: VX2730 run, {channels} channels x {records} records x "
        f"{wave_length} samples")
    run = "run_smoke"
    config = {"show_progress": False,
              "events": {"grouping_backend": "device"},
              "event_hits": {"grouping_backend": "device"},
              "df_paired": {"grouping_backend": "device",
                            "events_source": "columnar"}}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        waves = make_pulse_waves(channels * records, wave_length,
                                 seed=seed).reshape(channels, records,
                                                    wave_length)
        make_synthetic_vx2730_run(root, run, n_channels=channels,
                                  waves=waves, channel_offset_ps=1000)
        size = sum(p.stat().st_size for p in Path(root).rglob("*.CSV"))
        log(f"  wrote {size / 1e6:.0f} MB of CSV in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = ["--data-root", root, "--run-name", run, "--quiet",
                "--config-json", json.dumps(config)]
        timings = {}
        for attempt in ("cold", "warm"):
            for target in cli_targets():
                t0 = time.perf_counter()
                rc = cli.main(argv + ["--target", target])
                assert rc == 0, f"waveform-process --target {target}: rc {rc}"
                timings[(attempt, target)] = time.perf_counter() - t0
        for target in cli_targets():
            log(f"  target {target}: cold {timings[('cold', target)]:.2f} s,"
                f" warm (cache hit) {timings[('warm', target)]:.2f} s")
        if "df_paired" not in cli_targets():
            log("  df_paired skipped: pandas is not installed")
        for target in cli_targets():
            assert timings[("warm", target)] < timings[("cold", target)], \
                f"{target}: the re-run was not faster (no cache hit?)"
        check_cli_outputs(root, run, waves, config, n_check)
    log("cli ok")


# --------------------------------------------------------------------------
# 4. the fused Context program: platform kernels vs xla
# --------------------------------------------------------------------------

def phase_fused(seed: int, n: int = N, wave_length: int = L) -> None:
    import numpy as np

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.ops.dispatch import kernel_for
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
    from waveformanalysis_tpu.testing.fixtures import (
        make_fake_st_waveforms,
        make_pulse_waves,
    )

    log(f"== fused: ctx.get_data(run, 's1_s2') on {n} x {wave_length} "
        f"st_waveforms; auto picks '{kernel_for('peaks')}' for peaks")
    st = make_fake_st_waveforms(n_events=n, wave_length=wave_length,
                                n_channels=16, baseline=8000.0,
                                polarity="negative")
    st["wave"] = make_pulse_waves(n, wave_length, seed=seed + 2)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("auto", "xla"):
            times = []
            for rep in range(2):
                ctx = Context(storage_dir=os.path.join(tmp, backend + str(rep)),
                              config={"show_progress": False})
                ctx.register(*default_plugins())
                ctx.set_config({"hit": {"peaks_backend": backend}})
                ctx.inject_data("run", "st_waveforms", st)
                t0 = time.perf_counter()
                tables = {name: ctx.get_data("run", name)
                          for name in ("s1_s2", "waveform_width", "hit")}
                times.append(time.perf_counter() - t0)
                ctx.flush_saves()
            out[backend] = tables
            log(f"  {backend}: first {times[0]:.2f} s (compiles), "
                f"second {times[1]:.2f} s")
    for name in ("hit", "waveform_width", "s1_s2"):
        a, b = out["xla"][name], out["auto"][name]
        assert len(a) == len(b) > 0, f"{name}: {len(b)} vs {len(a)} rows"
        for f in a.field_names:
            x, y = np.asarray(a[f]), np.asarray(b[f])
            if x.dtype.kind in "biu":
                exact(f"{name}.{f} auto vs xla", y, x)
            else:
                close(f"{name}.{f} auto vs xla", y, x, 1e-3, 1e-5,
                      "float32 interpolation, FMA contraction")
    log("fused ok")


def phase_mesh(cards: int, seed: int) -> None:
    from waveformanalysis_tpu.testing.mesh_checks import run_mesh_checks

    log(f"== mesh: {cards} cards x {MESH_EVENTS} events x {L} samples, "
        "against the one-card Context")
    t0 = time.perf_counter()
    summary = run_mesh_checks(cards, events_per_device=MESH_EVENTS,
                              wave_length=L, chunk_size=MESH_EVENTS // 2,
                              log=lambda m: log("  " + m))
    log(f"mesh ok ({time.perf_counter() - t0:.1f} s): {summary}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card mesh path")
    args = ap.parse_args(argv)

    devices = phase_device(args.cards)
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_mesh(args.cards, args.seed)
    else:
        phase_kernels(args.seed)
        phase_gpu_tests()
        phase_cli(args.seed)
        phase_fused(args.seed)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
