#!/usr/bin/env python
"""Advanced tutorial: custom plugins, multi-run batching, DAQ scanning.

Follows the reference advanced notebook's arc (/root/reference/
tutorial_advanced.ipynb: scan DAQ runs -> write a custom feature plugin ->
register -> single-run trial -> multi-run batch), then adds the device
continuation: batched device dispatch and a device mesh.
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
    from waveformanalysis_tpu.testing.fixtures import make_synthetic_vx2730_run

    daq_root = str(Path(tmp) / "DAQ")
    run_ids = [f"run_{i:03d}" for i in range(3)]
    for i, rid in enumerate(run_ids):
        make_synthetic_vx2730_run(daq_root, run_name=rid, n_channels=2,
                                  n_rows=48, n_samples=96, noise=5,
                                  seed=100 + i)

    # -- 2. scan the DAQ tree ------------------------------------------------
    section("2. scan DAQ runs")
    from waveformanalysis_tpu.utils.daq import DAQAnalyzer

    analyzer = DAQAnalyzer(daq_root, adapter_name="vx2730")
    analyzer.scan_all_runs()
    runs = analyzer.get_all_runs()
    print(f"found {len(runs)} runs: {[r.run_name for r in runs]}")

    # -- 3. a custom feature plugin -------------------------------------------
    section("3. custom plugin: pulse FWHM feature")
    from waveformanalysis_tpu.config.option import Option
    from waveformanalysis_tpu.dtypes.schema import Field, Schema
    from waveformanalysis_tpu.dtypes.table import Table
    from waveformanalysis_tpu.plugins.base import Plugin

    PULSE_WIDTH_SCHEMA = Schema(
        "pulse_width",
        (Field("timestamp", "i8", unit="ps"),
         Field("channel", "i2"),
         Field("fwhm_samples", "f4")),
    )

    class PulseWidthPlugin(Plugin):
        """Full-width-half-max of the baseline-subtracted pulse."""

        provides = "pulse_width"
        depends_on = ["st_waveforms"]
        description = "FWHM (in samples) per waveform."
        version = "1.0.0"
        save_when = "always"
        output_dtype = PULSE_WIDTH_SCHEMA
        options = {
            "baseline_samples": Option(default=16, type=int,
                                       help="Leading samples for baseline"),
        }

        def compute(self, context, run_id, **kwargs):
            st = context.get_data(run_id, "st_waveforms")
            nb = int(context.get_config(self, "baseline_samples"))
            waves = np.stack([np.asarray(w) for w in st["wave"]]).astype(
                np.float32)
            base = waves[:, :nb].mean(axis=1, keepdims=True)
            sig = np.abs(waves - base)
            half = sig.max(axis=1, keepdims=True) / 2.0
            above = sig >= half
            fwhm = above.sum(axis=1).astype(np.float32)
            return Table({
                "timestamp": np.asarray(st["timestamp"], np.int64),
                "channel": np.asarray(st["channel"], np.int16),
                "fwhm_samples": fwhm,
            }, schema=PULSE_WIDTH_SCHEMA)

    # -- 4. context + registration --------------------------------------------
    section("4. Context + registration")
    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

    ctx = Context(
        storage_dir=str(Path(tmp) / "store"),
        config={"data_root": daq_root, "daq_adapter": "vx2730",
                "n_channels": 2, "show_progress": False},
    )
    ctx.register(*default_plugins())
    ctx.register(PulseWidthPlugin())
    print(ctx.help("pulse_width"))

    # -- 5. single-run trial + feature join ------------------------------------
    section("5. single-run trial")
    pw = ctx.get_data(run_ids[0], "pulse_width")
    feats = ctx.get_data(run_ids[0], "basic_features")
    print(f"pulse_width: {len(pw)} rows, mean FWHM "
          f"{float(np.mean(np.asarray(pw['fwhm_samples']))):.1f} samples")
    area = np.asarray(feats["area"])
    fwhm = np.asarray(pw["fwhm_samples"])
    if fwhm.std() > 0 and area.std() > 0:
        print(f"area-vs-FWHM corr: {np.corrcoef(area, fwhm)[0, 1]:.3f}")
    else:
        print(f"FWHM constant at {fwhm[0]:.0f} samples on this synthetic "
              f"run (fixed pulse shape) — join by row works regardless")

    # -- 6. multi-run batching ---------------------------------------------------
    section("6. multi-run batching")
    from waveformanalysis_tpu.data.batch_processor import BatchProcessor

    bp = BatchProcessor(ctx)
    batch = bp.process_runs(run_ids, "df")
    print(batch.summary())
    for rid in batch.succeeded:
        df = batch.get(rid).data
        print(f"  {rid}: {len(df)} rows, mean area {df['area'].mean():.1f}")

    # batched device dispatch: all runs concatenated into ONE program
    batched = ctx.get_data_batched(run_ids, "basic_features")
    print(f"batched device dispatch: "
          f"{sum(len(v) for v in batched.values())} rows across "
          f"{len(batched)} runs in one fused program")

    # -- 7. next steps: shard over a mesh ----------------------------------------
    section("7. next steps (device features)")
    import jax

    if len(jax.devices()) > 1:
        from waveformanalysis_tpu.parallel.mesh import make_mesh

        ctx.attach_mesh(make_mesh(min(8, len(jax.devices()))))
        hit = ctx.get_data(run_ids[1], "hit_threshold")
        print(f"mesh-sharded hit_threshold: {len(hit)} rows over "
              f"{len(jax.devices())} devices")
    else:
        print("single device — see examples/multichip_demo.py for meshes")
    ctx.flush_saves()


if __name__ == "__main__":
    main()
