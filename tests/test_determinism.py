"""End-to-end determinism (SURVEY §7 hard part: lineage determinism across
jit): identical inputs + identical config must produce BIT-identical
outputs and cache payloads, independently of context instance, fusion
strategy, and async-save timing. If any kernel picked up data-dependent
recompilation drift, these tests catch it.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from utils import create_daq_run
from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

TARGETS = ["st_waveforms", "records", "basic_features", "hit",
           "hit_threshold", "waveform_width", "s1_s2", "df_events"]


def _build(tmp_path, sub, daq_root, fused=True):
    ctx = Context(
        storage_dir=str(tmp_path / sub),
        config={
            "show_progress": False,
            "data_root": str(daq_root),
            "daq_adapter": "vx2730",
            "n_channels": 2,
            "fused_execution": fused,
            "channel_metadata": {"0:0": {"polarity": "positive"},
                                 "0:1": {"polarity": "positive"}},
        },
    )
    ctx.register(*default_plugins())
    ctx.set_config({
        "hit": {"use_filtered": False, "use_derivative": False,
                "height": 100.0, "prominence": 50.0, "width": 2},
        "hit_threshold": {"threshold": 100.0},
        "s1_s2": {"s1_width_range": (0.0, 30.0),
                  "s2_width_range": (30.0, 100000.0)},
    })
    return ctx


def _table_digest(obj) -> str:
    h = hashlib.sha256()
    if isinstance(obj, Table):
        for name in obj.field_names:
            h.update(name.encode())
            h.update(np.ascontiguousarray(np.asarray(obj[name])).tobytes())
    elif isinstance(obj, np.ndarray):
        h.update(np.ascontiguousarray(obj).tobytes())
    elif hasattr(obj, "columns") and hasattr(obj, "iloc"):  # DataFrame
        for c in obj.columns:
            h.update(str(c).encode())
            col = obj[c].to_numpy()
            if col.dtype == object:
                for cell in col:
                    h.update(np.ascontiguousarray(np.asarray(cell)).tobytes())
            else:
                h.update(np.ascontiguousarray(col).tobytes())
    else:
        h.update(repr(obj).encode())
    return h.hexdigest()


@pytest.fixture(scope="module")
def daq_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_daq")
    create_daq_run(root, "run_D", n_channels=2, n_rows=20, n_samples=64,
                   pulse_height=-300)
    return root


class TestRunToRunDeterminism:
    def test_two_contexts_bit_identical(self, tmp_path, daq_root):
        c1 = _build(tmp_path, "a", daq_root)
        c2 = _build(tmp_path, "b", daq_root)
        for target in TARGETS:
            d1 = _table_digest(c1.get_data("run_D", target))
            d2 = _table_digest(c2.get_data("run_D", target))
            assert d1 == d2, f"nondeterministic output: {target}"

    def test_fused_vs_unfused_bit_identical(self, tmp_path, daq_root):
        cf = _build(tmp_path, "f", daq_root, fused=True)
        cu = _build(tmp_path, "u", daq_root, fused=False)
        for target in TARGETS:
            df_ = _table_digest(cf.get_data("run_D", target))
            du = _table_digest(cu.get_data("run_D", target))
            assert df_ == du, f"fusion changed numerics: {target}"

    def test_cache_payload_bytes_identical(self, tmp_path, daq_root):
        c1 = _build(tmp_path, "p1", daq_root)
        c2 = _build(tmp_path, "p2", daq_root)
        for ctx in (c1, c2):
            ctx.get_data("run_D", "s1_s2")
            ctx.flush_saves()

        def payloads(root):
            out = {}
            for p in sorted(Path(root).rglob("*.bin")):
                out[p.name] = hashlib.sha256(p.read_bytes()).hexdigest()
            return out

        p1 = payloads(tmp_path / "p1")
        p2 = payloads(tmp_path / "p2")
        assert p1 and p1 == p2  # same keys AND same bytes

    def test_disk_reload_digest_matches_compute(self, tmp_path, daq_root):
        ctx = _build(tmp_path, "r", daq_root)
        before = {t: _table_digest(ctx.get_data("run_D", t)) for t in TARGETS}
        clone = ctx.clone()
        for t in TARGETS:
            after = _table_digest(clone.get_data("run_D", t))
            assert after == before[t], f"reload changed {t}"
