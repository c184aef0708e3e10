"""Hardware-channel config layering (reference analog:
core/hardware/channel.py:17-747): run_config channel_metadata wins over
context-config metadata; per-channel > per-group > run-block defaults;
polarity/gain/fixed-baseline resolution, vectorized override arrays, and
channel_config option interplay.
"""

import json

import numpy as np
import pytest

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.hardware import (
    HardwareChannel,
    get_channel_metadata,
    get_polarity,
    make_channel,
    parse_channel_ref,
    resolve_channel_value_arrays,
    unique_hardware_channels,
)
from waveformanalysis_tpu.plugins.base import Option, Plugin


class _Probe(Plugin):
    provides = "probe"
    depends_on = []
    save_when = "never"
    options = {
        "threshold": Option(default=5.0, type=float),
        "channel_config": Option(default=None, type=dict),
    }

    def compute(self, context, run_id, **kwargs):
        return None


class TestChannelRefs:
    def test_parse_forms(self):
        assert parse_channel_ref("1:3") == HardwareChannel(1, 3)
        assert parse_channel_ref((2, 4)) == HardwareChannel(2, 4)
        assert parse_channel_ref("bogus:x") is None

    def test_unique_channels(self):
        boards = np.array([0, 0, 1, 1, 0])
        chans = np.array([1, 1, 2, 2, 3])
        uniq = unique_hardware_channels(boards, chans)
        assert set(uniq) == {make_channel(0, 1), make_channel(1, 2),
                             make_channel(0, 3)}


class TestMetadataLayering:
    def _ctx(self, tmp_path, ctx_meta=None, run_meta=None):
        cfg = {"show_progress": False}
        if ctx_meta is not None:
            cfg["channel_metadata"] = ctx_meta
        ctx = Context(storage_dir=str(tmp_path), config=cfg)
        if run_meta is not None:
            run_dir = tmp_path / "r1"
            run_dir.mkdir(parents=True, exist_ok=True)
            (run_dir / "run_config.json").write_text(
                json.dumps({"channel_metadata": run_meta})
            )
            ctx.set_config({
                "run_config_path_template":
                    str(tmp_path) + "/{run_id}/run_config.json",
            })
        return ctx

    def test_context_metadata_resolves(self, tmp_path):
        ctx = self._ctx(tmp_path, ctx_meta={"0:2": {"polarity": "positive"}})
        assert get_polarity(ctx, "r1", 0, 2) == "positive"
        assert get_polarity(ctx, "r1", 0, 3) == "unknown"

    def test_run_config_wins_over_context(self, tmp_path):
        ctx = self._ctx(
            tmp_path,
            ctx_meta={"0:2": {"polarity": "positive"}},
            run_meta={"0:2": {"polarity": "negative"}},
        )
        assert get_polarity(ctx, "r1", 0, 2) == "negative"

    def test_invalid_polarity_falls_back(self, tmp_path):
        ctx = self._ctx(tmp_path, ctx_meta={"0:2": {"polarity": "sideways"}})
        assert get_polarity(ctx, "r1", 0, 2) == "unknown"

    def test_metadata_dict_values(self, tmp_path):
        ctx = self._ctx(tmp_path, ctx_meta={
            "1:5": {"gain_adc_per_pe": 42.0, "fixed_baseline": 990.0},
        })
        meta = get_channel_metadata(ctx, "r1", 1, 5)
        assert meta["gain_adc_per_pe"] == 42.0
        assert meta["fixed_baseline"] == 990.0


class TestVectorizedOverrides:
    def test_channel_config_option_overrides(self, tmp_path):
        ctx = Context(storage_dir=str(tmp_path),
                      config={"show_progress": False})
        probe = _Probe()
        ctx.register(probe)
        boards = np.zeros(6, np.int16)
        chans = np.array([0, 0, 1, 1, 2, 2], np.int16)
        out = resolve_channel_value_arrays(
            ctx, probe, "r", boards, chans,
            option_names=("threshold",),
            defaults={"threshold": 5.0},
            channel_config={"0:1": {"threshold": 9.0}},
        )
        thr = out["threshold"]
        np.testing.assert_array_equal(thr[chans == 1], 9.0)
        np.testing.assert_array_equal(thr[chans != 1], 5.0)

    def test_missing_override_yields_default(self, tmp_path):
        ctx = Context(storage_dir=str(tmp_path),
                      config={"show_progress": False})
        probe = _Probe()
        ctx.register(probe)
        out = resolve_channel_value_arrays(
            ctx, probe, "r", np.zeros(3, np.int16),
            np.arange(3, dtype=np.int16),
            option_names=("threshold",), defaults={"threshold": 7.5},
            channel_config=None,
        )
        np.testing.assert_array_equal(out["threshold"], 7.5)


class TestPluginPolarityFlow:
    def test_polarity_metadata_reaches_st_waveforms(self, tmp_path):
        from utils import create_daq_run
        from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

        create_daq_run(tmp_path / "daq", "rp", n_channels=2, n_rows=6,
                       n_samples=32)
        ctx = Context(
            storage_dir=str(tmp_path / "st"),
            config={
                "show_progress": False,
                "data_root": str(tmp_path / "daq"),
                "daq_adapter": "vx2730",
                "channel_metadata": {
                    "0:0": {"polarity": "negative"},
                    "0:1": {"polarity": "positive"},
                },
            },
        )
        ctx.register(*default_plugins())
        st = ctx.get_data("rp", "st_waveforms")
        pol = np.asarray(st["polarity"])
        ch = np.asarray(st["channel"])
        assert np.all(pol[ch == 0] == -1)
        assert np.all(pol[ch == 1] == 1)
