#!/usr/bin/env python
"""Differential fuzz: the full chain (models/full_chain.py) against the
per-event NumPy/SciPy oracle (testing/oracles.py) across random configs
(polarity mixes, variable lengths, capacity overflow paths).

Any mismatch prints the config that produced it. A pre-release sweep
beyond the fixed tests (tests/test_chain_oracle.py).

    JAX_PLATFORMS=cpu python scripts/fuzz_chain_configs.py [n_trials]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from waveformanalysis_tpu.models.full_chain import (  # noqa: E402
    ChainConfig,
    full_chain_step,
)
from waveformanalysis_tpu.testing.oracles import chain_oracle  # noqa: E402


def main(n_trials: int = 14, seed: int = 99) -> int:
    rng = np.random.default_rng(seed)
    fails = 0
    for trial in range(n_trials):
        L = int(rng.choice([64, 96, 128, 192]))
        n = 256
        t = np.arange(L)
        waves = np.full((n, L), 1000.0)
        for i in range(n):
            for c in rng.integers(4, L - 4, size=rng.integers(0, 4)):
                s = rng.uniform(1.5, 20)
                waves[i] += (rng.choice([-1, 1]) * rng.uniform(30, 400)
                             * np.exp(-((t - c) ** 2) / (2 * s * s)))
        waves += rng.normal(0, rng.uniform(0.5, 4), waves.shape)
        waves = np.round(np.clip(waves, -32768, 32767)).astype(np.int16)
        el = np.full(n, L, np.int32)
        el[rng.integers(0, n, 10)] = rng.integers(8, L, 10)
        pol = (rng.random(n) < 0.5).astype(np.int8)
        bl = np.full(n, 1000.0, np.float32)
        cfg = ChainConfig(
            use_derivative=bool(rng.integers(2)),
            peak_height=float(rng.choice([5, 30, 80])),
            peak_distance=int(rng.choice([1, 2, 5])),
            peak_prominence=float(rng.choice([0.7, 10, 50])),
            peak_width=float(rng.choice([0, 2, 4])),
            max_peaks=int(rng.choice([4, 8])),
            hit_threshold=float(rng.choice([5, 10, 40])),
            left_extension=int(rng.choice([0, 2])),
            right_extension=int(rng.choice([0, 2])),
            max_hits=int(rng.choice([4, 8])),
            height_range=(int(rng.integers(0, 8)), int(rng.integers(32, 64))),
        )
        args = (jnp.asarray(waves), jnp.asarray(el), jnp.asarray(bl),
                jnp.asarray(pol))
        ref = jax.tree.map(np.asarray, full_chain_step(*args, cfg))
        got = chain_oracle(waves, el, bl, pol, cfg)
        bad = [k for k in got
               if not np.allclose(ref[k], got[k], atol=2e-3, rtol=1e-4)]
        print(f"trial {trial:2d} L={L:3d} deriv={cfg.use_derivative} "
              f"K={cfg.max_peaks} Kh={cfg.max_hits}: "
              f"{'OK' if not bad else 'MISMATCH ' + str(bad) + repr(cfg)}")
        fails += bool(bad)
    print("failures:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    raise SystemExit(main(n))
