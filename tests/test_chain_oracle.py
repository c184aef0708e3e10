"""The plain full chain (models/full_chain.py) against a per-event
NumPy/SciPy oracle, slot widths against a host oracle, and the sharded
chain on the virtual CPU mesh against the single-device chain.

The oracles (waveformanalysis_tpu/testing/oracles.py) are written from the
kernels' contracts one event at a time with scipy.signal.find_peaks /
peak_prominences / peak_widths, independent of the batched device
formulations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from waveformanalysis_tpu.models.full_chain import (
    ChainConfig,
    example_chain_batch,
    full_chain_step,
)
from waveformanalysis_tpu.ops.widths import width_from_peak_slots
from waveformanalysis_tpu.testing.oracles import (
    chain_oracle,
    corrected,
    width_oracle,
)


# --------------------------------------------------------------------------
# full chain vs the oracle
# --------------------------------------------------------------------------

def _mixed_waves(n, L, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    waves = np.full((n, L), 1000.0)
    for i in range(n):
        c = rng.integers(50, L - 50)
        amp = rng.choice([300, -280]) if i % 5 else 0
        waves[i] += amp * np.exp(-((t - c) ** 2)
                                 / (2 * rng.uniform(2, 20) ** 2))
    waves += rng.normal(0, 3, waves.shape)
    return np.round(waves).astype(np.int16)


def _chain_case(name):
    rng = np.random.default_rng(11)
    n, L = 50, 192
    waves = _mixed_waves(n, L)
    el = rng.integers(L // 2, L + 1, n).astype(np.int32)
    bl = np.full(n, 1000.0, np.float32)
    pos = np.ones(n, np.int8)
    plain = ChainConfig(use_derivative=False, peak_height=60.0,
                        peak_prominence=30.0, peak_width=1.5)
    if name == "positive_polarity_varlen":
        return plain, waves, el, bl, pos
    if name == "negative_polarity":
        return plain, waves, el, bl, -pos
    if name == "mixed_polarity":
        return plain, waves, el, bl, rng.choice(np.array([-1, 1], np.int8), n)
    if name == "derivative_mode":
        return (ChainConfig(use_derivative=True, peak_height=20.0,
                            peak_prominence=5.0, peak_width=1.0,
                            peak_distance=3), waves, el, bl, pos)
    if name == "dense_noise_high_capacity":
        noisy = (1000 + rng.normal(0, 40, (n, L))).round().astype(np.int16)
        return (ChainConfig(use_derivative=False, peak_height=10.0,
                            peak_prominence=2.0, peak_width=0.5,
                            peak_distance=1, max_peaks=16, max_hits=16,
                            hit_threshold=5.0), noisy, el, bl, pos)
    if name == "boundary_plateaus":
        w2 = np.full((3, 64), 1000, np.int16)
        w2[0, 10:40] = 1100   # plateau to the el=40 boundary -> no peak
        w2[1, 10:39] = 1100   # falls inside -> midpoint peak
        w2[2, 30] = 1400
        return (ChainConfig(use_derivative=False, peak_height=50.0,
                            peak_prominence=0.0, peak_width=0.0),
                w2, np.array([40, 40, 64], np.int32),
                np.full(3, 1000.0, np.float32), np.ones(3, np.int8))
    if name == "s1_s2_classification":
        batch = [np.asarray(a) for a in example_chain_batch(32, 128)]
        return (ChainConfig(use_derivative=False, peak_height=80.0,
                            peak_prominence=50.0, peak_width=2.0), *batch)
    raise KeyError(name)


CHAIN_CASES = [
    "positive_polarity_varlen", "negative_polarity", "mixed_polarity",
    "derivative_mode", "dense_noise_high_capacity", "boundary_plateaus",
    "s1_s2_classification",
]


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_full_chain_matches_host_oracle(case):
    cfg, waves, el, bl, pol = _chain_case(case)
    out = full_chain_step(jnp.asarray(waves), jnp.asarray(el),
                          jnp.asarray(bl), jnp.asarray(pol), cfg)
    ref = chain_oracle(waves, el, bl, pol, cfg)
    assert set(ref) == set(out)
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(out[k])
        if k in ("peak_position", "n_peaks", "n_hits", "label",
                 "n_peak_overflow", "n_hit_overflow"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            # f32 device arithmetic vs the float64 oracle
            np.testing.assert_allclose(b, a, atol=2e-3, rtol=1e-5,
                                       err_msg=k)
    if case == "s1_s2_classification":
        assert (ref["label"][0::2] == 1).all()
        assert (ref["label"][1::2] == 2).all()


def test_sharded_chain_matches_single_device():
    """make_sharded_chain over the virtual CPU mesh: per-event outputs equal
    the single-device chain; psum statistics equal global reductions."""
    from waveformanalysis_tpu.models.full_chain import (
        CHAIN_STATS_KEYS,
        make_sharded_chain,
    )
    from waveformanalysis_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    if n_dev < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    cfg = ChainConfig(use_derivative=False, peak_height=80.0,
                      peak_prominence=50.0, peak_width=2.0)
    n, L = n_dev * 16, 128
    batch = (jnp.asarray(_mixed_waves(n, L)), jnp.full(n, L, jnp.int32),
             jnp.full(n, 1000.0, jnp.float32), jnp.ones(n, jnp.int8))
    mesh = make_mesh(n_devices=n_dev, axis_names=("data",))
    out = {k: np.asarray(v) for k, v in
           make_sharded_chain(mesh, cfg)(*batch).items()}
    single = {k: np.asarray(v) for k, v in
              full_chain_step(*batch, cfg).items()}
    for k, v in single.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert set(CHAIN_STATS_KEYS) <= set(out)
    assert out["n_s1"] == np.sum(single["label"] == 1)
    assert out["n_s2"] == np.sum(single["label"] == 2)
    np.testing.assert_allclose(out["total_area"], single["area"].sum(),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# slot widths vs the host oracle
# --------------------------------------------------------------------------

def _width_case(name):
    rng = np.random.default_rng(21)
    n, L, K = 24, 160, 4
    t = np.arange(L)
    waves = np.full((n, L), 1000.0) + rng.normal(0, 2, (n, L))
    pos = np.full((n, K), -1, np.int32)
    for i in range(n):
        for k, c in enumerate(rng.choice(np.arange(60, L - 20, 17), 2,
                                         replace=False)):
            sigma = 3.0 if name != "wide_pulses" else 20.0
            waves[i] += 300 * np.exp(-((t - c) ** 2) / (2 * sigma ** 2))
            pos[i, k] = c
    interpolation = name != "no_interpolation"
    if name == "negative_peaks":
        waves = 2000.0 - waves      # corrected peak <= 0: width_valid False
    if name == "edge_positions":
        pos[:, 2] = 0
        pos[:, 3] = L - 1
    if name == "plateau_crossings":
        waves = np.round(waves / 50.0) * 50.0   # exact-equal neighbours
    valid = pos >= 0
    return waves.astype(np.float32), pos, valid, interpolation


WIDTH_CASES = ["narrow_pulses", "wide_pulses", "no_interpolation",
               "negative_peaks", "edge_positions", "plateau_crossings"]


@pytest.mark.parametrize("case", WIDTH_CASES)
def test_width_from_peak_slots_matches_host_oracle(case):
    waves, pos, valid, interpolation = _width_case(case)
    out = {k: np.asarray(v) for k, v in width_from_peak_slots(
        jnp.asarray(waves), jnp.asarray(pos), jnp.asarray(valid),
        interpolation=interpolation).items()}
    np.testing.assert_array_equal(out["valid"], valid)
    np.testing.assert_array_equal(out["position"], pos)
    corr = corrected(waves)
    for i, k in zip(*np.nonzero(valid)):
        ref = width_oracle(corr[i], int(pos[i, k]), 0.1, 0.9, interpolation)
        assert out["width_valid"][i, k] == ref["width_valid"], (i, k)
        for key in ("rise_samples", "fall_samples", "total_samples",
                    "peak_height"):
            np.testing.assert_allclose(out[key][i, k], ref[key], atol=2e-3,
                                       rtol=1e-5, err_msg=f"{key}[{i},{k}]")
