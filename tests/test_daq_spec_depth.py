"""DAQRun/DAQAnalyzer depth + PluginSpec structural checks
(reference analog: utils/daq/daq_run.py:49 + daq_analyzer.py:43 and
core/plugins/core/spec.py:30-394).
"""

import json

import numpy as np
import pytest

from utils import create_daq_run, write_v1725_run
from waveformanalysis_tpu.plugins.spec import (
    Capabilities,
    InputRequirement,
    OutputSchema,
    PluginSpec,
)
from waveformanalysis_tpu.utils.daq import DAQAnalyzer, DAQRun


@pytest.fixture()
def daq_root(tmp_path):
    create_daq_run(tmp_path, "run_A", n_channels=2, n_files_per_channel=2,
                   n_rows=8, n_samples=32)
    create_daq_run(tmp_path, "run_B", n_channels=1, n_rows=4, n_samples=32)
    return tmp_path


class TestDAQRun:
    def test_scan_and_channels(self, daq_root):
        run = DAQRun(str(daq_root), "run_A")
        assert run.channels == [0, 1]  # property
        files = run.get_channel_files()
        assert len(files[0]) == 2 and len(files[1]) == 2

    def test_channel_stats_and_window(self, daq_root):
        run = DAQRun(str(daq_root), "run_A")
        stats = run.channel_stats()
        assert set(stats) == {0, 1}
        st0 = stats[0]
        # 8 rows/file at 10 ms spacing: the acquisition window spans them
        assert st0.acquisition_window_s is None or st0.acquisition_window_s >= 0
        d = st0.to_dict()
        assert "n_files" in d or "first_timetag" in d or len(d) > 0

    def test_overview_renders(self, daq_root):
        run = DAQRun(str(daq_root), "run_A")
        text = run.overview()
        assert "run_A" in text or "channel" in text.lower()

    def test_export_json(self, daq_root, tmp_path):
        run = DAQRun(str(daq_root), "run_A")
        out = tmp_path / "run.json"
        run.export_json(str(out))
        payload = json.loads(out.read_text())
        assert payload
        json.dumps(payload)  # fully serializable

    def test_missing_run_yields_empty(self, daq_root):
        # DAQ inspection is forgiving: a missing run scans to no channels
        # (the PROCESSING path raises; loader tests cover that)
        run = DAQRun(str(daq_root), "ghost_run")
        assert run.scan() == {}
        assert run.channels == []


class TestDAQAnalyzer:
    def test_list_runs(self, daq_root):
        an = DAQAnalyzer(str(daq_root))
        assert sorted(an.list_runs()) == ["run_A", "run_B"]

    def test_summary_and_dict(self, daq_root):
        an = DAQAnalyzer(str(daq_root))
        text = an.summary()
        assert "run_A" in text
        d = an.to_dict()
        json.dumps(d)

    def test_get_run(self, daq_root):
        an = DAQAnalyzer(str(daq_root))
        run = an.get_run("run_A")
        assert isinstance(run, DAQRun)


class TestPluginSpec:
    def test_output_schema_from_dtype(self):
        dtype = np.dtype([
            ("time", "i8"), ("height", "f4"), ("wave", "i2", (64,)),
        ])
        schema = OutputSchema.from_dtype(dtype)
        names = [f.name for f in schema.fields]
        assert names == ["time", "height", "wave"]
        wave_field = schema.fields[2]
        assert tuple(getattr(wave_field, "shape", ()) or ()) in ((64,), ())

    def test_spec_from_every_builtin(self):
        from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

        for plugin in default_plugins():
            spec = PluginSpec.from_plugin(plugin)
            assert spec.provides == plugin.provides
            problems = spec.validate()
            assert problems == [], f"{plugin.provides}: {problems}"
            # round-trips through a dict (doc generator contract)
            d = spec.to_dict() if hasattr(spec, "to_dict") else None
            if d is not None:
                json.dumps(d, default=str)

    def test_spec_hash_in_lineage(self, tmp_path):
        """A spec change (new option) rotates the plugin's cache key."""
        from waveformanalysis_tpu.config.option import Option
        from waveformanalysis_tpu.dtypes.table import Table
        from waveformanalysis_tpu.plugins.base import Plugin
        from waveformanalysis_tpu.testing.fixtures import make_tiny_context

        class V1(Plugin):
            provides = "spec_probe"
            depends_on = []
            save_when = "never"
            options = {"a": Option(default=1, type=int)}

            def compute(self, context, run_id, **kwargs):
                return Table({"x": np.arange(1)})

        class V2(V1):
            options = {"a": Option(default=1, type=int),
                       "b": Option(default=2, type=int)}

        ctx1 = make_tiny_context(tmp_path / "1")
        ctx1.register(V1())
        ctx2 = make_tiny_context(tmp_path / "2")
        ctx2.register(V2())
        assert ctx1.key_for("r", "spec_probe") != ctx2.key_for("r", "spec_probe")
