"""GPU streaming-scan kernels (ops/scan_kernels.py) against their references.

On the CPU the Triton-route kernels run through the Pallas interpreter,
which executes the same kernel body; the compiled kernels are checked on a
GPU by the ``gpu``-marked tests at the end (and by chip_smoke.py at full
width). References: the XLA formulations (ops/peaks.py, ops/hits.py) and
scipy.signal.sosfiltfilt.
"""

import zlib

import numpy as np
import pytest
from scipy.signal import sosfiltfilt

import jax.numpy as jnp

from waveformanalysis_tpu.ops.dispatch import KERNELS, kernel_for
from waveformanalysis_tpu.ops.filtering import (
    _sosfiltfilt_device_core,
    design_butterworth_sos,
    sosfilt_zi,
    sosfiltfilt_padlen,
)
from waveformanalysis_tpu.ops.hits import threshold_hits_batch
from waveformanalysis_tpu.ops.peaks import find_peaks_batch
from waveformanalysis_tpu.ops.scan_kernels import (
    BLOCK,
    find_peaks_scan,
    sosfiltfilt_scan,
    threshold_hits_scan,
)


def _assert_same(ref, out, atol, rtol=1e-5):
    assert set(out) == set(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(out[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=k)


# --------------------------------------------------------------------------
# find_peaks
# --------------------------------------------------------------------------

def _pulses(n, L, polarity, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    waves = np.full((n, L), 1000.0)
    for i in range(n):
        c = rng.integers(L // 4, 3 * L // 4)
        waves[i] += polarity * 300 * np.exp(
            -((t - c) ** 2) / (2 * rng.uniform(2, 12) ** 2))
    waves += rng.normal(0, 3, waves.shape)
    return np.round(waves).astype(np.float32)


def _peaks_case(name):
    """(signal, valid_length or None, kwargs) for one scenario."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kw = dict(height=30.0, prominence=10.0, width=1.0, distance=3,
              max_peaks=8)
    if name == "noise_pulse_varlen":
        sig = rng.normal(0, 30, (40, 128)).astype(np.float32)
        sig[:, 50:60] += 200
        return sig, rng.integers(64, 129, 40).astype(np.int32), kw
    if name == "plateaus":
        sig = np.zeros((8, 96), np.float32)
        for i in range(8):
            j = rng.integers(10, 60)
            sig[i, j:j + rng.integers(2, 6)] = 100.0
        return sig, None, dict(kw, height=10.0, prominence=0.0, width=0.0,
                               distance=1)
    if name in ("positive_polarity", "negative_polarity"):
        pol = 1.0 if name == "positive_polarity" else -1.0
        w = _pulses(48, 160, pol, seed=3)
        return pol * (w - 1000.0), None, dict(kw, height=60.0,
                                              prominence=30.0, width=1.5)
    if name == "derivative_mode":
        w = _pulses(48, 160, 1.0, seed=4)
        el = rng.integers(80, 161, 48).astype(np.int32)
        return (np.diff(w, axis=1), np.maximum(el - 1, 0),
                dict(kw, height=20.0, prominence=5.0, width=1.0))
    if name == "dense_noise_overflow":
        sig = rng.normal(0, 40, (64, 128)).astype(np.float32)
        return sig, None, dict(height=10.0, prominence=2.0, width=0.5,
                               distance=1, max_peaks=16)
    if name == "small_capacity_distance":
        sig = rng.normal(0, 40, (64, 128)).astype(np.float32)
        return sig, None, dict(height=10.0, prominence=2.0, width=0.5,
                               distance=4, max_peaks=3)
    if name == "boundary_plateaus":
        sig = np.zeros((3, 64), np.float32)
        sig[0, 10:40] = 100   # plateau to the el=40 boundary -> no peak
        sig[1, 10:39] = 100   # falls inside -> midpoint peak
        sig[2, 30] = 400
        return sig, np.array([40, 40, 64], np.int32), dict(
            kw, height=50.0, prominence=0.0, width=0.0, distance=1)
    if name == "equal_height_ties":
        sig = np.zeros((16, 64), np.float32)
        for i in range(16):
            sig[i, 10 + i % 3] = 50.0
            sig[i, 14] = 50.0
            sig[i, 40] = 50.0 + (i % 2)
            sig[i, 43] = 50.0
        return sig, None, dict(kw, height=10.0, prominence=0.0, width=0.0,
                               distance=5)
    if name == "short_and_empty_lengths":
        sig = rng.normal(0, 30, (24, 64)).astype(np.float32)
        return sig, (np.arange(24) % 6).astype(np.int32), kw
    if name == "ragged_block_remainder":
        # n not a multiple of the block, L not a power of two
        n, L = BLOCK + 3, 97
        sig = rng.normal(0, 20, (n, L)).astype(np.float32)
        sig[:, 40:46] += 150
        return sig, rng.integers(30, L + 1, n).astype(np.int32), kw
    raise KeyError(name)


PEAK_CASES = [
    "noise_pulse_varlen", "plateaus", "positive_polarity",
    "negative_polarity", "derivative_mode", "dense_noise_overflow",
    "small_capacity_distance", "boundary_plateaus", "equal_height_ties",
    "short_and_empty_lengths", "ragged_block_remainder",
]


@pytest.mark.parametrize("case", PEAK_CASES)
def test_find_peaks_scan_matches_xla(case):
    sig, vlen, kw = _peaks_case(case)
    vl = None if vlen is None else jnp.asarray(vlen)
    ref = find_peaks_batch(jnp.asarray(sig), kw["height"], kw["prominence"],
                           kw["width"], distance=kw["distance"],
                           max_peaks=kw["max_peaks"], valid_length=vl)
    out = find_peaks_scan(jnp.asarray(sig), kw["height"], kw["prominence"],
                          kw["width"], distance=kw["distance"],
                          max_peaks=kw["max_peaks"], valid_length=vl,
                          interpret=True)
    assert np.asarray(out["position"]).shape == (sig.shape[0],
                                                 kw["max_peaks"])
    _assert_same(ref, out, atol=1e-3, rtol=1e-4)


# --------------------------------------------------------------------------
# threshold runs
# --------------------------------------------------------------------------

def _hits_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    kw = dict(left_extension=2, right_extension=2, max_hits=8)
    if name == "pulses_varlen_per_event_thresholds":
        sig = rng.normal(0, 15, (40, 128)).astype(np.float32)
        sig[:, 30:45] += 80
        sig[:, 70:72] += 60
        return (sig, rng.uniform(20, 60, 40).astype(np.float32),
                rng.integers(64, 129, 40).astype(np.int32), kw)
    if name == "run_to_boundary_and_overflow":
        sig = np.zeros((4, 96), np.float32)
        for i in range(10):
            sig[:, 5 + 9 * i: 8 + 9 * i] = 100.0
        sig[:, 90:] = 100.0  # runs into the wave end
        return (sig, np.full(4, 30.0, np.float32), np.full(4, 96, np.int32),
                dict(left_extension=1, right_extension=1, max_hits=4))
    if name == "dense_noise":
        sig = rng.normal(0, 20, (64, 128)).astype(np.float32)
        return (sig, np.full(64, 10.0, np.float32),
                np.full(64, 128, np.int32), dict(kw, max_hits=16))
    if name == "no_extensions":
        sig = rng.normal(0, 20, (32, 64)).astype(np.float32)
        return (sig, np.full(32, 15.0, np.float32),
                np.full(32, 64, np.int32),
                dict(left_extension=0, right_extension=0, max_hits=8))
    if name == "wide_extensions_overlapping_tails":
        sig = np.zeros((8, 64), np.float32)
        sig[:, 10] = sig[:, 12] = sig[:, 14] = 50.0   # runs 1 sample apart
        sig[:, 30:33] = [60.0, 70.0, 60.0]
        sig += rng.normal(0, 1, sig.shape).astype(np.float32)
        return (sig, np.full(8, 25.0, np.float32), np.full(8, 64, np.int32),
                dict(left_extension=3, right_extension=4, max_hits=8))
    if name == "runs_cut_by_valid_length":
        sig = np.zeros((6, 48), np.float32)
        sig[:, 20:40] = 90.0
        return (sig, np.full(6, 30.0, np.float32),
                np.array([48, 40, 30, 21, 20, 0], np.int32), kw)
    if name == "ragged_block_remainder":
        n, L = BLOCK + 5, 97
        sig = rng.normal(0, 15, (n, L)).astype(np.float32)
        sig[:, 50:58] += 70
        return (sig, rng.uniform(20, 40, n).astype(np.float32),
                rng.integers(1, L + 1, n).astype(np.int32), kw)
    if name == "negative_signal_integral":
        # integral sums max(segment, 0); heights may be negative-free
        sig = -np.abs(rng.normal(0, 10, (16, 64))).astype(np.float32)
        sig[:, 20:24] = [5.0, 40.0, 45.0, 5.0]
        return (sig, np.full(16, 30.0, np.float32),
                np.full(16, 64, np.int32), kw)
    raise KeyError(name)


HIT_CASES = [
    "pulses_varlen_per_event_thresholds", "run_to_boundary_and_overflow",
    "dense_noise", "no_extensions", "wide_extensions_overlapping_tails",
    "runs_cut_by_valid_length", "ragged_block_remainder",
    "negative_signal_integral",
]


@pytest.mark.parametrize("case", HIT_CASES)
def test_threshold_hits_scan_matches_xla(case):
    sig, thr, vlen, kw = _hits_case(case)
    args = (jnp.asarray(sig), jnp.asarray(thr), jnp.asarray(vlen))
    ref = threshold_hits_batch(*args, **kw)
    out = threshold_hits_scan(*args, interpret=True, **kw)
    # sums run in time order here and in tree order in XLA
    _assert_same(ref, out, atol=1e-3)


# --------------------------------------------------------------------------
# zero-phase IIR
# --------------------------------------------------------------------------

def _rel_err(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _filter_waves(n=48, L=256, offset=1000.0, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    return (offset + rng.normal(0, 30, (n, L))
            + 200 * np.exp(-((t - L // 2) ** 2) / 50.0)).astype(np.float32)


# (waves kwargs, (order, lo, hi), relative tolerance vs scipy float64)
FILTER_CASES = {
    "order2": ({}, (2, 0.1, 0.2), 5e-5),
    "order4": ({}, (4, 0.05, 0.22), 5e-4),
    "dc_offset": ({"offset": 16000.0}, (2, 0.1, 0.2), 5e-4),
    "few_events": ({"n": 7}, (2, 0.1, 0.2), 5e-5),
    "odd_length": ({"L": 97}, (2, 0.1, 0.2), 5e-5),
    "multi_block": ({"n": 2 * BLOCK + 9, "L": 64}, (2, 0.1, 0.2), 5e-5),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_sosfiltfilt_scan_matches_scipy(case):
    wkw, design, tol = FILTER_CASES[case]
    waves = _filter_waves(**wkw)
    sos = design_butterworth_sos(*design, 0.5)
    ref = sosfiltfilt(sos, waves.astype(np.float64), axis=-1)
    out = np.asarray(sosfiltfilt_scan(waves, sos, interpret=True))
    assert out.shape == waves.shape
    assert _rel_err(out, ref) < tol


def test_sosfiltfilt_scan_matches_associative_scan():
    waves = _filter_waves()
    sos = design_butterworth_sos(2, 0.1, 0.2, 0.5)
    xla = np.asarray(_sosfiltfilt_device_core(
        jnp.asarray(waves), jnp.asarray(sos, jnp.float32),
        jnp.asarray(sosfilt_zi(sos), jnp.float32), sosfiltfilt_padlen(sos)))
    out = np.asarray(sosfiltfilt_scan(waves, sos, interpret=True))
    assert _rel_err(out, xla) < 5e-5


def test_sosfiltfilt_scan_rejects_short_waves():
    sos = design_butterworth_sos(2, 0.1, 0.2, 0.5)
    with pytest.raises(ValueError, match="padlen"):
        sosfiltfilt_scan(np.zeros((2, sosfiltfilt_padlen(sos)), np.float32),
                         sos, interpret=True)


# --------------------------------------------------------------------------
# the kernel table
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["peaks", "hits", "sosfiltfilt"])
def test_kernel_table_auto(op):
    assert kernel_for(op, "auto", platform="gpu") == "scan"
    assert kernel_for(op, "auto", platform="cpu") == "xla"
    # platforms without hand kernels get the plain XLA formulations
    assert kernel_for(op, "auto", platform="rocm") == "xla"
    # explicit choices are taken as given
    assert kernel_for(op, "xla", platform="gpu") == "xla"
    assert kernel_for(op, "scan", platform="cpu") == "scan"


def test_kernel_table_default_platform_is_this_backend():
    import jax

    expected = KERNELS.get(jax.default_backend(), KERNELS["cpu"])["peaks"]
    assert kernel_for("peaks") == expected


@pytest.mark.parametrize("op,backend", [("widths", "auto"),
                                        ("peaks", "pallas")])
def test_kernel_table_rejects_unknown(op, backend):
    with pytest.raises(ValueError):
        kernel_for(op, backend)


def test_plugins_resolve_through_the_table(tmp_context):
    from waveformanalysis_tpu.plugins.builtin.hit_finder import (
        ThresholdHitPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.peak_finding import (
        HitFinderPlugin,
    )

    hit, thr = HitFinderPlugin(), ThresholdHitPlugin()
    tmp_context.register(hit, thr)
    assert hit.kernel_config(tmp_context)["backend"] == "xla"
    assert thr.kernel_config(tmp_context)["backend"] == "xla"
    tmp_context.set_config({"hit": {"peaks_backend": "scan"},
                            "hit_threshold": {"hits_backend": "scan"}})
    assert hit.kernel_config(tmp_context)["backend"] == "scan"
    assert thr.kernel_config(tmp_context)["backend"] == "scan"
    # the neighbor-threshold condition exists only in the XLA formulation
    tmp_context.set_config({"hit": {"threshold": 1.0}})
    assert hit.kernel_config(tmp_context)["backend"] == "xla"


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_filter_plugin_resolves_its_backend_through_the_table(
        tmp_context, monkeypatch, backend):
    from waveformanalysis_tpu.ops import filtering as FLT
    from waveformanalysis_tpu.plugins.builtin.filtering import (
        FilteredWaveformsPlugin,
    )
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms

    asked = []

    def spy(op, requested="auto", platform=None):
        asked.append((op, requested))
        return kernel_for(op, requested, platform)

    monkeypatch.setattr(FLT, "kernel_for", spy)
    tmp_context.register(FilteredWaveformsPlugin())
    tmp_context.set_config({"filtered_waveforms": {
        "filter_type": "BW", "lowcut": 0.02, "highcut": 0.2,
        "filter_backend": backend}})
    st = make_fake_st_waveforms(n_events=6, wave_length=96)
    tmp_context.inject_data("run", "st_waveforms", st)
    out = tmp_context.get_data("run", "filtered_waveforms")
    assert asked and set(asked) == {("sosfiltfilt", backend)}
    ref = sosfiltfilt(FLT.design_butterworth_sos(4, 0.02, 0.2, 0.5),
                      np.asarray(st["wave"], np.float64), axis=-1)
    np.testing.assert_allclose(np.asarray(out["wave"]), ref, rtol=1e-4,
                               atol=1e-2)


# --------------------------------------------------------------------------
# compiled kernels (GPU only)
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_compiled_find_peaks_scan(gpu_device):
    sig, vlen, kw = _peaks_case("noise_pulse_varlen")
    sig = np.tile(sig, (64, 1))
    vl = jnp.asarray(np.tile(vlen, 64))
    ref = find_peaks_batch(jnp.asarray(sig), kw["height"], kw["prominence"],
                           kw["width"], distance=kw["distance"],
                           max_peaks=kw["max_peaks"], valid_length=vl)
    out = find_peaks_scan(jnp.asarray(sig), kw["height"], kw["prominence"],
                          kw["width"], distance=kw["distance"],
                          max_peaks=kw["max_peaks"], valid_length=vl)
    _assert_same(ref, out, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
def test_compiled_threshold_hits_scan(gpu_device):
    sig, thr, vlen, kw = _hits_case("pulses_varlen_per_event_thresholds")
    args = (jnp.asarray(np.tile(sig, (64, 1))), jnp.asarray(np.tile(thr, 64)),
            jnp.asarray(np.tile(vlen, 64)))
    _assert_same(threshold_hits_batch(*args, **kw),
                 threshold_hits_scan(*args, **kw), atol=1e-3)


@pytest.mark.gpu
def test_compiled_sosfiltfilt_scan(gpu_device):
    waves = _filter_waves(n=4 * BLOCK)
    sos = design_butterworth_sos(2, 0.1, 0.2, 0.5)
    ref = sosfiltfilt(sos, waves.astype(np.float64), axis=-1)
    assert _rel_err(np.asarray(sosfiltfilt_scan(waves, sos)), ref) < 5e-5
