"""Contract tests (reference analog: tests/contracts/):

- every builtin plugin exposes a valid, serializable PluginSpec with unique
  provides and resolvable acyclic dependencies;
- the golden path raw_files -> st_waveforms -> basic_features works with
  stub plugins;
- cache keys: same inputs -> same key; config/version change -> different key
  (covered in test_context, spot-checked here at profile scale);
- deprecation aliases warn and resolve.
"""

import json
import warnings

import numpy as np
import pytest

from waveformanalysis_tpu.config.compat import CompatManager
from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.context.resolution import resolve_dependencies
from waveformanalysis_tpu.plugins.base import Option, Plugin
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.plugins.spec import PluginSpec


@pytest.fixture(scope="module")
def profile_ctx(tmp_path_factory):
    ctx = Context(storage_dir=str(tmp_path_factory.mktemp("store")),
                  config={"show_progress": False})
    ctx.register(*default_plugins())
    from waveformanalysis_tpu.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.cache_analysis import (
        CacheAnalysisPlugin,
    )

    ctx.register(SignalPeaksStreamPlugin(), CacheAnalysisPlugin())
    return ctx


class TestPluginContracts:
    """reference analog: tests/contracts/test_plugin_contracts.py"""

    def test_every_plugin_has_valid_spec(self, profile_ctx):
        for name, plugin in profile_ctx.plugins.items():
            spec = plugin._validated_spec
            assert spec is not None, f"{name} has no validated spec"
            assert spec.validate() == [], f"{name} spec invalid"
            # serializable
            blob = json.dumps(spec.to_dict(), default=str)
            assert len(blob) > 0
            assert spec.spec_hash()

    def test_unique_provides(self, profile_ctx):
        names = [p.provides for p in profile_ctx.plugins.values()]
        assert len(names) == len(set(names))

    def test_dependencies_resolvable_and_acyclic(self, profile_ctx):
        for name in profile_ctx.plugins:
            plan = resolve_dependencies(
                profile_ctx, name, profile_ctx._plugins
            )
            assert plan[-1] == name
            assert len(plan) == len(set(plan))  # acyclic topo order

    def test_versions_are_semver(self, profile_ctx):
        from packaging.version import Version

        for name, plugin in profile_ctx.plugins.items():
            Version(plugin.version)  # raises on invalid

    def test_save_when_values(self, profile_ctx):
        for plugin in profile_ctx.plugins.values():
            assert plugin.save_when in ("never", "always", "target")

    def test_lineage_json_serializable(self, profile_ctx):
        for name in profile_ctx.plugins:
            lineage = profile_ctx.get_lineage(name)
            json.dumps(lineage, sort_keys=True, default=str)

    def test_keys_stable_across_contexts(self, profile_ctx, tmp_path):
        ctx2 = Context(storage_dir=str(tmp_path), config={"show_progress": False})
        ctx2.register(*default_plugins())
        for name in ("basic_features", "hit", "df_paired", "records"):
            assert profile_ctx.key_for("r", name) == ctx2.key_for("r", name)


class TestGoldenPath:
    """reference analog: tests/contracts/test_golden_path.py"""

    def test_stubbed_chain(self, tmp_path):
        class StubRawFiles(Plugin):
            provides = "raw_files"
            save_when = "never"

            def compute(self, context, run_id, **kwargs):
                return [["fake_ch0.csv"], ["fake_ch1.csv"]]

        class StubWaveforms(Plugin):
            provides = "st_waveforms"
            depends_on = ["raw_files"]
            save_when = "always"

            def compute(self, context, run_id, **kwargs):
                raw = context.get_data(run_id, "raw_files")
                n = 4 * len(raw)
                from waveformanalysis_tpu.dtypes.schema import ST_WAVEFORM_SCHEMA
                from waveformanalysis_tpu.dtypes.table import Table

                tbl = Table.zeros(n, ST_WAVEFORM_SCHEMA, wave_length=32)
                cols = dict(tbl.columns)
                cols["baseline"] = np.full(n, 100.0)
                cols["timestamp"] = np.arange(n, dtype=np.int64) * 1000
                cols["record_id"] = np.arange(n, dtype=np.int64)
                cols["dt"] = np.full(n, 2, np.int32)
                cols["event_length"] = np.full(n, 32, np.int32)
                cols["channel"] = (np.arange(n) % 2).astype(np.int16)
                wave = np.full((n, 32), 100, np.int16)
                wave[:, 10:15] = 60
                cols["wave"] = wave
                return Table(cols, schema=ST_WAVEFORM_SCHEMA)

        from waveformanalysis_tpu.plugins.builtin.basic_features import (
            BasicFeaturesPlugin,
        )

        ctx = Context(storage_dir=str(tmp_path), config={"show_progress": False})
        ctx.register(StubRawFiles(), StubWaveforms(), BasicFeaturesPlugin())
        ctx.set_config({"basic_features": {"height_range": (0, None)}})
        out = ctx.get_data("golden", "basic_features")
        assert len(out) == 8
        np.testing.assert_allclose(np.asarray(out["height"]), 40.0)
        # chain executed in order and cached
        assert ctx.is_cache_hit("golden", "st_waveforms")
        assert ctx.is_cache_hit("golden", "basic_features")


class TestCompatDeprecation:
    """reference analog: tests/contracts/test_compat_deprecation.py"""

    def test_alias_warns_once_and_resolves(self, tmp_path):
        class P(Plugin):
            provides = "compat_test"
            options = {"new_name": Option(default=1, type=int)}

            def compute(self, context, run_id, **kwargs):
                return np.zeros(1)

        CompatManager.register_alias(
            "old_name", "new_name", plugin_name="compat_test",
            deprecated_in="1.0", removed_in="2.0",
        )
        try:
            ctx = Context(storage_dir=str(tmp_path),
                          config={"show_progress": False})
            ctx.register(P())
            ctx.set_config({"old_name": 7})
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                value = ctx.get_config("compat_test", "new_name")
            assert value == 7
            messages = [str(w.message) for w in rec
                        if issubclass(w.category, DeprecationWarning)]
            assert any("old_name" in m for m in messages)
        finally:
            CompatManager.unregister_alias("old_name", "compat_test")
