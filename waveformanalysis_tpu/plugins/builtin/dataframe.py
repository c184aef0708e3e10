"""df plugin: single-channel events DataFrame at the API boundary.

Behavioral analog of the reference DataFramePlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/dataframe.py:31):
basic_features joined with source identity into a pandas DataFrame; optional
per-hardware-channel ``gain_adc_per_pe`` (explicit config > run_config
calibration block) adds area_pe/height_pe calibrated columns.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np

from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.hardware import parse_channel_ref
from waveformanalysis_tpu.plugins.base import Option, Plugin
from waveformanalysis_tpu.plugins.builtin._wave_source import (
    WAVE_SOURCE_AUTO,
    resolve_wave_input_spec,
)

logger = logging.getLogger(__name__)


class DataFramePlugin(Plugin):
    """Build the initial single-channel events DataFrame."""

    provides = "df"
    depends_on = []  # dynamic
    description = "Build the initial single-channel events DataFrame."
    version = "1.10.0"
    save_when = "always"
    uses_run_config = True
    output_dtype = "DataFrame"
    options = {
        "use_filtered": Option(default=False, type=bool,
                               help="Use filtered_waveforms as the source"),
        "wave_source": Option(default=WAVE_SOURCE_AUTO, type=str,
                              help="auto|records|st_waveforms|filtered_waveforms"),
        "gain_adc_per_pe": Option(
            default=None, type=dict,
            help='Per-hardware-channel ADC/PE gains, keys "board:channel"; '
                 "adds area_pe/height_pe columns",
        ),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        spec = resolve_wave_input_spec(context, self)
        return list(spec.depends_on) + ["basic_features"]

    def compute(self, context: Any, run_id: str, **kwargs: Any):
        features = context.get_data(run_id, "basic_features")
        if not isinstance(features, Table):
            features = Table.from_numpy(features)
        n = len(features)
        # pandas only where a DataFrame is built: registering the default
        # profile must not need it (pyproject extra "full")
        import pandas as pd

        df = pd.DataFrame({
            "timestamp": np.asarray(features["timestamp"], np.int64),
            "board": np.asarray(features["board"], np.int16),
            "channel": np.asarray(features["channel"], np.int16),
            # keep the kernels' float32 (reference dtype parity: its df
            # carries basic_features' f4 straight through, and the CSV the
            # CLI exports round-trips shorter — caught by the r5 CLI
            # differential)
            "height": np.asarray(features["height"]),
            "amp": np.asarray(features["amp"]),
            "area": np.asarray(features["area"]),
            "max_abs_diff": np.asarray(features["max_abs_diff"]),
            "event_index": np.asarray(features["event_index"], np.int64),
        })
        # reference column name for the same identity (reference df exposes
        # the source row index as record_id, dataframe.py analog) — kept
        # alongside event_index so porting users find both
        df["record_id"] = df["event_index"]

        gain_map, enabled = self._resolve_gain_map(context, run_id)
        if enabled and n:
            gains = np.full(n, np.nan)
            for key, gain in gain_map.items():
                hw = parse_channel_ref(key)
                if hw is None:
                    logger.warning("df.gain_adc_per_pe: invalid channel key %r", key)
                    continue
                try:
                    g = float(gain)
                except (TypeError, ValueError):
                    logger.warning("df.gain_adc_per_pe[%r]=%r invalid", key, gain)
                    continue
                if g <= 0:
                    logger.warning(
                        "df.gain_adc_per_pe[%s]=%s non-positive; NaN for channel",
                        key, g,
                    )
                    continue
                sel = (df["board"].to_numpy() == hw.board) & (
                    df["channel"].to_numpy() == hw.channel
                )
                gains[sel] = g
            df["area_pe"] = df["area"] / gains
            df["height_pe"] = df["height"] / gains
        return df

    def _resolve_gain_map(self, context: Any, run_id: str):
        """explicit config > run_config calibration block > disabled."""
        gain = context.get_config(self, "gain_adc_per_pe")
        if isinstance(gain, dict) and gain:
            return dict(gain), True
        run_config = context.get_run_config(run_id)
        if isinstance(run_config, dict):
            calib = run_config.get("calibration")
            if isinstance(calib, dict) and isinstance(
                calib.get("gain_adc_per_pe"), dict
            ):
                return dict(calib["gain_adc_per_pe"]), True
            if isinstance(run_config.get("gain_adc_per_pe"), dict):
                return dict(run_config["gain_adc_per_pe"]), True
        return {}, False
