#!/usr/bin/env python
"""Fused-chain demo: the whole features -> peaks -> hits -> widths -> S1/S2
chain as ONE jitted device program (models/full_chain.py).

Runs a mixed S1/S2 batch through the single-device chain and the chain
sharded over every local device, checks that both agree, and reports
classification accuracy.

(reference analog: examples/s1_s2_pipeline_demo.ipynb, BASELINE config #4 —
but through the fused device chain instead of the plugin DAG)
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

import jax

import waveformanalysis_tpu as wa
from waveformanalysis_tpu.models.full_chain import example_chain_batch
from waveformanalysis_tpu.parallel.mesh import make_mesh


def main() -> None:
    n_dev = len(jax.devices())
    n_events = (4096 if jax.default_backend() != "cpu" else 256) * n_dev

    cfg = wa.ChainConfig(use_derivative=False, peak_height=80.0,
                         peak_prominence=50.0, peak_width=2.0)
    batch = example_chain_batch(n_events=n_events, wave_length=256)
    truth = np.where(np.arange(n_events) % 2 == 0, 1, 2)  # odd idx = wide S2

    mesh = make_mesh(n_devices=n_dev, axis_names=("data",))
    steps = {
        "single": wa.make_jit_chain(cfg),
        f"sharded x{n_dev}": wa.make_sharded_chain(mesh, cfg),
    }

    outs = {}
    for name, step in steps.items():
        t0 = time.perf_counter()
        out = step(*batch)
        jax.block_until_ready(out)
        outs[name] = out
        labels = np.asarray(out["label"])
        acc = float(np.mean(labels == truth))
        print(f"{name:12s} {time.perf_counter() - t0:6.2f} s "
              f"(incl. compile)  accuracy={acc:.3f}  "
              f"S1={int((labels == 1).sum())} S2={int((labels == 2).sum())}")

    ref, other = outs.values()
    same = all(
        np.array_equal(np.asarray(ref[k]), np.asarray(other[k]))
        for k in ("label", "n_peaks", "peak_position", "n_hits")
    )
    print(f"sharded outputs identical to the single-device chain: {same}")


if __name__ == "__main__":
    main()
