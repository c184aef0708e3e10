"""OneTimeGenerator + get_plugins_from_context (reference:
core/foundation/utils.py:280-345)."""

import pytest

from waveformanalysis_tpu.foundation.utils import (
    OneTimeGenerator,
    get_plugins_from_context,
)


class TestOneTimeGenerator:
    def test_single_pass_yields_everything(self):
        g = OneTimeGenerator(iter(range(5)), name="five")
        assert list(g) == [0, 1, 2, 3, 4]

    def test_second_iter_raises(self):
        g = OneTimeGenerator(iter(range(3)))
        list(g)
        with pytest.raises(RuntimeError, match="already been consumed"):
            list(g)

    def test_raises_even_when_first_pass_partial(self):
        g = OneTimeGenerator(iter(range(10)), name="partial")
        it = iter(g)
        assert next(it) == 0
        with pytest.raises(RuntimeError, match="partial"):
            iter(g).__next__()

    def test_next_protocol(self):
        g = OneTimeGenerator(iter([7, 8]))
        assert next(g) == 7
        assert next(g) == 8
        with pytest.raises(StopIteration):
            next(g)

    def test_facade_export(self):
        import waveformanalysis_tpu as wfa

        assert wfa.OneTimeGenerator is OneTimeGenerator


class TestGetPluginsFromContext:
    def test_none(self):
        assert get_plugins_from_context(None) == {}

    def test_underscore_plugins(self):
        class C:
            _plugins = {"a": 1}

        assert get_plugins_from_context(C()) == {"a": 1}

    def test_plain_plugins(self):
        class C:
            plugins = {"b": 2}

        assert get_plugins_from_context(C()) == {"b": 2}

    def test_real_context(self, tmp_path):
        from waveformanalysis_tpu.context.context import Context
        from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

        ctx = Context(storage_dir=str(tmp_path),
                      config={"show_progress": False})
        ctx.register(*default_plugins())
        plugins = get_plugins_from_context(ctx)
        assert "basic_features" in plugins
