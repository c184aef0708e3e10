#!/usr/bin/env python
"""Multi-run batched dispatch: the batch dimension as the parallel axis.

The reference fans runs over host process pools; on a device the idiomatic
equivalent is ONE device program per batch — runs concatenate on the event
axis, sharing a single upload, dispatch, and fetch
(reference analog: core/data/batch_processor.py:197).
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.data.batch_processor import BatchProcessor
from waveformanalysis_tpu.plugins.builtin.basic_features import BasicFeaturesPlugin
from waveformanalysis_tpu.plugins.builtin.dataframe import DataFramePlugin
from waveformanalysis_tpu.plugins.builtin.event_analysis import GroupedEventsPlugin
from waveformanalysis_tpu.plugins.builtin.hit_finder import ThresholdHitPlugin
from waveformanalysis_tpu.plugins.builtin.peak_finding import HitFinderPlugin
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms


def make_run(n_events: int, seed: int):
    st = make_fake_st_waveforms(
        n_events=n_events, wave_length=128, pulse_height=300,
        polarity="positive", noise_rms=3.0, seed=seed,
    )
    st["channel"] = (np.arange(n_events) % 2).astype(np.int16)
    return st


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(BasicFeaturesPlugin(), HitFinderPlugin(),
                     ThresholdHitPlugin(), DataFramePlugin(),
                     GroupedEventsPlugin())
        ctx.set_config({"hit": {"use_filtered": False, "use_derivative": False,
                                "height": 100.0, "prominence": 50.0,
                                "width": 2}})

        run_ids = [f"run_{i:03d}" for i in range(6)]
        for i, rid in enumerate(run_ids):
            ctx.inject_data(rid, "st_waveforms", make_run(512, seed=i))

        # direct API: several targets, several runs, jointly planned
        t0 = time.perf_counter()
        out = ctx.get_data_batched(run_ids, ["basic_features", "hit"])
        dt = time.perf_counter() - t0
        total = sum(len(out[r]["basic_features"]) for r in run_ids)
        print(f"batched {len(run_ids)} runs / {total} events in {dt:.2f}s "
              f"-> {total / dt / 1e3:.1f}k ev/s")
        for rid in run_ids[:2]:
            print(f"  {rid}: {len(out[rid]['hit'])} peaks")

        # BatchProcessor front-end: same dispatch, RunResult bookkeeping
        bp = BatchProcessor(ctx, executor_type="device")
        res = bp.process_runs(run_ids, "df_events")
        print(res.summary())
        ctx.flush_saves()


if __name__ == "__main__":
    main()
