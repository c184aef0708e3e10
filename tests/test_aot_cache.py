"""AOT program cache: persisted traced programs skip the fresh-process
re-trace and reproduce the jit path bit-for-bit.

The persistent XLA compile cache keys on HLO, which only exists after
tracing; foundation/aot_cache.py persists the trace itself (jax.export
StableHLO) keyed by (program key, plugin versions, jax version, platform,
arg shapes). These tests force the cache on for the CPU backend via
WFA_AOT_CACHE_DIR and drive the real fused-bundle programs.
"""

import os

import numpy as np
import pytest

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.foundation import aot_cache
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms


MEMBERS = ("basic_features", "hit", "hit_threshold",
           "waveform_width_integral")
RUN = "run_aot"


@pytest.fixture()
def aot_dir(tmp_path, monkeypatch):
    d = tmp_path / "aot"
    monkeypatch.setenv("WFA_AOT_CACHE_DIR", str(d))
    monkeypatch.setattr(aot_cache, "_disabled_for_process", False)
    return d


@pytest.fixture()
def basic_context(tmp_path):
    ctx = Context(storage_dir=str(tmp_path / "store"),
                  config={"show_progress": False})
    ctx.register(*default_plugins())
    st = make_fake_st_waveforms(
        n_events=40, wave_length=64, n_channels=2, pulse_start=20,
        pulse_width=6, pulse_height=250, noise_rms=2.0, seed=3,
    )
    ctx.inject_data(RUN, "st_waveforms", st)
    return ctx


def _fresh_engine_program(ctx):
    """A NEW engine instance (empty in-process memo) over ctx's plugins —
    what a fresh process sees, minus the interpreter start."""
    from waveformanalysis_tpu.context.fusion import WaveChainFusion

    eng = WaveChainFusion()
    plugins = {m: ctx._plugins[m] for m in MEMBERS}
    cfgs = {m: plugins[m].kernel_config(ctx) for m in MEMBERS}
    return eng._get_program(MEMBERS, cfgs, plugins, None)


def _args(n=64, length=128, seed=0):
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    waves = (rng.randn(n, length) * 40).astype(np.int16)
    return tuple(jnp.asarray(x) for x in (
        waves, np.full((n,), length, np.int32), np.ones((n,), np.float32),
        np.zeros((n,), np.float32), np.full((n,), 50.0, np.float32),
    ))


def _run(program, spec_cache, args):
    import jax

    flat, slot_mats, counts = jax.block_until_ready(program(*args))
    shapes_key = tuple((tuple(a.shape), str(a.dtype)) for a in args)
    return (np.asarray(flat), [np.asarray(m) for m in slot_mats],
            np.asarray(counts), spec_cache[shapes_key])


def test_miss_then_hit_bit_identical(basic_context, aot_dir):
    ctx = basic_context
    args = _args()

    prog1, sc1 = _fresh_engine_program(ctx)
    flat1, mats1, counts1, spec1 = _run(prog1, sc1, args)
    aot_cache.flush()
    files = list(aot_dir.glob("*.stablehlo"))
    assert len(files) == 1, "miss path must persist exactly one program"

    prog2, sc2 = _fresh_engine_program(ctx)
    flat2, mats2, counts2, spec2 = _run(prog2, sc2, args)
    # white-box: the hit path never built the fallback jit (no re-trace)
    assert prog2._jit is None, "AOT hit still re-traced the program"

    assert np.array_equal(flat1, flat2)
    assert np.array_equal(counts1, counts2)
    for a, b in zip(mats1, mats2):
        assert np.array_equal(a, b)
    # restored packing spec unpacks identically: same treedef + metas
    assert spec1[0] == spec2[0]
    assert spec1[1] == spec2[1]


def test_results_match_end_to_end(basic_context, tmp_path, monkeypatch):
    """Context-level: a bundle computed through an AOT hit equals the
    plain-jit bundle field-for-field."""
    from waveformanalysis_tpu.context import fusion as fz

    ctx = basic_context
    run = RUN
    baseline = {
        name: _to_arrays(ctx.get_data(run, name)) for name in MEMBERS
    }

    monkeypatch.setenv("WFA_AOT_CACHE_DIR", str(tmp_path / "aot2"))
    monkeypatch.setattr(aot_cache, "_disabled_for_process", False)
    # warm the disk cache with a fresh engine, then clear data caches and
    # recompute through another fresh engine (disk AOT hit)
    monkeypatch.setattr(fz, "_DEFAULT_RULES", [fz.WaveChainFusion()])
    for name in MEMBERS:
        ctx.clear_cache_for(run, name)
    again = {name: _to_arrays(ctx.get_data(run, name)) for name in MEMBERS}
    aot_cache.flush()

    monkeypatch.setattr(fz, "_DEFAULT_RULES", [fz.WaveChainFusion()])
    for name in MEMBERS:
        ctx.clear_cache_for(run, name)
    hit = {name: _to_arrays(ctx.get_data(run, name)) for name in MEMBERS}

    for name in MEMBERS:
        for f, v in baseline[name].items():
            assert np.array_equal(v, again[name][f]), (name, f)
            assert np.array_equal(v, hit[name][f]), (name, f)


def test_corrupt_entry_degrades_to_miss(basic_context, aot_dir):
    ctx = basic_context
    args = _args()
    prog1, sc1 = _fresh_engine_program(ctx)
    flat1, *_ = _run(prog1, sc1, args)
    aot_cache.flush()
    for f in aot_dir.glob("*.stablehlo"):
        f.write_bytes(b"garbage")

    prog2, sc2 = _fresh_engine_program(ctx)
    flat2, *_ = _run(prog2, sc2, args)
    assert prog2._jit is not None, "corrupt entry should re-trace"
    assert np.array_equal(flat1, flat2)


def test_key_sensitivity(basic_context, aot_dir):
    """A config change and a shape change each map to distinct entries."""
    ctx = basic_context
    args = _args()
    prog1, sc1 = _fresh_engine_program(ctx)
    _run(prog1, sc1, args)
    aot_cache.flush()
    assert len(list(aot_dir.glob("*.stablehlo"))) == 1

    # different shapes -> second entry
    args_small = _args(n=32, length=128)
    prog2, sc2 = _fresh_engine_program(ctx)
    _run(prog2, sc2, args_small)
    aot_cache.flush()
    assert len(list(aot_dir.glob("*.stablehlo"))) == 2

    # different device-relevant config -> third entry
    ctx.set_config({"hit": {"height": 77.0}})
    prog3, sc3 = _fresh_engine_program(ctx)
    _run(prog3, sc3, args)
    aot_cache.flush()
    assert len(list(aot_dir.glob("*.stablehlo"))) == 3


def test_default_off_on_cpu(basic_context, tmp_path, monkeypatch):
    """Without WFA_AOT_CACHE_DIR the CPU backend writes nothing."""
    monkeypatch.delenv("WFA_AOT_CACHE_DIR", raising=False)
    assert aot_cache.cache_dir() is None
    ctx = basic_context
    prog, sc = _fresh_engine_program(ctx)
    _run(prog, sc, _args())
    aot_cache.flush()
    assert not list(tmp_path.glob("**/*.stablehlo"))


@pytest.mark.parametrize("xla_env", [False, True])
def test_accelerator_dir_follows_the_compile_cache(tmp_path, monkeypatch,
                                                   xla_env):
    """On an accelerator the AOT cache sits inside JAX_COMPILATION_CACHE_DIR
    when that is set, else beside the checkout's XLA cache."""
    monkeypatch.delenv("WFA_AOT_CACHE_DIR", raising=False)
    monkeypatch.delenv("WFA_NO_AOT_CACHE", raising=False)
    monkeypatch.setattr(aot_cache, "_configured_platform", lambda: "gpu")
    monkeypatch.setattr(aot_cache, "_disabled_for_process", False)
    if xla_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
        assert aot_cache.cache_dir() == str(tmp_path / "x" / "wfa_aot")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert aot_cache.cache_dir() == aot_cache.DEFAULT_CACHE_DIR
        assert aot_cache.DEFAULT_CACHE_DIR.endswith(
            os.path.join(".jax_cache", "aot"))


def test_short_lived_process_persists_export(tmp_path):
    """A process that exits right after computing a bundle must still
    write its export (atexit bounded flush): daemon export threads die
    with the interpreter, and short-lived processes — CLI invocations,
    batch workers — are exactly who the AOT cache serves. Without the
    flush, such processes exit before the export and the cache stays empty
    forever (the layer is silently inert)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    aot_dir = tmp_path / "aot"
    script = tmp_path / "short.py"
    script.write_text(
        "import os\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        f"os.environ['WFA_AOT_CACHE_DIR'] = {str(aot_dir)!r}\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from waveformanalysis_tpu.context.context import Context\n"
        "from waveformanalysis_tpu.plugins.plugin_sets import default_plugins\n"
        "from waveformanalysis_tpu.testing.fixtures import "
        "make_fake_st_waveforms\n"
        f"ctx = Context(storage_dir={str(tmp_path / 'store')!r},\n"
        "              config={'show_progress': False})\n"
        "ctx.register(*default_plugins())\n"
        "st = make_fake_st_waveforms(n_events=16, wave_length=32,\n"
        "                            n_channels=2, seed=1)\n"
        "ctx.inject_data('r', 'st_waveforms', st)\n"
        "ctx.get_data('r', ['basic_features', 'hit', 'hit_threshold'])\n"
        "ctx.flush_saves()\n"
        "# NO aot_cache.flush(): exit must not orphan the export\n"
    )
    pp = os.environ.get("PYTHONPATH")
    env = dict(os.environ,
               PYTHONPATH=str(repo) + (os.pathsep + pp if pp else ""))
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, cwd=str(repo), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    exports = list(aot_dir.glob("*.stablehlo"))
    assert exports, (
        "short-lived process wrote no AOT export; stderr tail:\n"
        + proc.stderr[-2000:]
    )


# -- helpers ---------------------------------------------------------------


def _to_arrays(table):
    return {f: np.asarray(table[f]) for f in table.field_names}
