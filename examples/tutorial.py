#!/usr/bin/env python
"""WaveformAnalysis getting-started tutorial (runnable walkthrough).

Follows the reference tutorial notebook's arc (/root/reference/
tutorial.ipynb: concepts -> context -> data -> structure -> plotting ->
config -> lineage -> preview) as one headless script. Each section prints
what a notebook cell would show.

Core concepts
-------------
- Context: the processing session — owns plugins, config, storage, cache.
- Plugin:  one data name (``provides``), declared dependencies, options.
- Lineage: every output is keyed by the sha1 of its full dependency +
  config cone; identical lineage = cache hit, changed lineage = recompute.
- Data flows st_waveforms -> basic_features/hit -> df/df_events ->
  df_paired, with the device kernels fused into single device programs.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def section(title):
    print("\n" + "=" * 70)
    print(title)
    print("=" * 70)


def main() -> None:
    tmp = tempfile.mkdtemp()

    # -- 0. look at the raw data ------------------------------------------
    section("0. a synthetic DAQ run (VX2730 CSV layout)")
    from waveformanalysis_tpu.testing.fixtures import make_synthetic_vx2730_run

    daq_root = str(Path(tmp) / "DAQ")
    make_synthetic_vx2730_run(daq_root, run_name="run_001", n_channels=2,
                              n_rows=96, n_samples=96, noise=5, seed=1)
    run_dir = Path(daq_root) / "run_001" / "RAW"
    files = sorted(p.name for p in run_dir.iterdir())
    print(f"{run_dir}: {files}")

    # -- 1/2. imports + Context + plugins ---------------------------------
    section("1-2. create a Context and register the default plugin set")
    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

    ctx = Context(
        storage_dir=str(Path(tmp) / "store"),
        config={"data_root": daq_root, "daq_adapter": "vx2730",
                "n_channels": 2, "show_progress": False},
    )
    ctx.register(*default_plugins())
    print(ctx.help())

    # -- 3. get data --------------------------------------------------------
    section("3. get data (computes the whole dependency cone once)")
    df = ctx.get_data("run_001", "df")
    print(df.head())
    df_paired = ctx.get_data("run_001", "df_paired")
    print(f"\ndf_paired: {len(df_paired)} paired events, "
          f"columns {list(df_paired.columns)[:8]}...")

    # -- 4. data structure ---------------------------------------------------
    section("4. data structure")
    st = ctx.get_data("run_001", "st_waveforms")
    print(f"st_waveforms: {len(st)} rows, fields {list(st.field_names)}")
    w0 = np.asarray(st["wave"][0])
    print(f"first wave: shape {w0.shape}, dtype {w0.dtype}, "
          f"head {w0[:8].tolist()}")

    # -- 5. waveform plotting -------------------------------------------------
    section("5. waveform plotting (Agg backend, saved to file)")
    try:
        import matplotlib

        matplotlib.use("Agg")
        from waveformanalysis_tpu.utils.visualization import plot_waveforms

        fig = plot_waveforms(st, n=4)
        out_png = Path(tmp) / "waves.png"
        fig.savefig(out_png)
        print(f"saved {out_png}")
    except Exception as exc:
        print(f"plotting skipped: {exc}")

    # -- 6. config management -------------------------------------------------
    section("6. config management (lineage-aware)")
    key_before = ctx.key_for("run_001", "hit")
    ctx.set_config({"hit": {"height": 150.0}})
    key_after = ctx.key_for("run_001", "hit")
    print(f"hit cache key: {key_before} -> {key_after} "
          f"(changed: {key_before != key_after})")
    ctx.list_plugin_configs(plugin_name="hit")

    # -- 7. lineage ------------------------------------------------------------
    section("7. lineage")
    lineage = ctx.get_lineage("df_paired")
    print(f"df_paired lineage covers: {sorted(lineage)}")

    # -- 8. preview the execution plan ------------------------------------------
    section("8. preview execution (no compute)")
    preview = ctx.preview_execution("run_001", "df_paired")
    print("plan:", preview["plan"])
    print("cache:", preview["cache_status"])

    section("summary: core API")
    print("Context(storage_dir=..., config=...); ctx.register(*default_plugins())\n"
          "ctx.get_data(run, name)      # compute or cache-load\n"
          "ctx.get_data(run, [a, b])    # jointly planned, fused on device\n"
          "ctx.set_config({...})        # lineage-aware, invalidates caches\n"
          "ctx.preview_execution(...)   # dry-run the plan\n"
          "ctx.list_plugin_configs()    # option catalogue\n"
          "ctx.help() / ctx.quickstart()")
    ctx.flush_saves()


if __name__ == "__main__":
    main()
