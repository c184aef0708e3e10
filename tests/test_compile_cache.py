"""Where the persistent XLA compile cache lives (foundation/compile_cache.py).

Each case runs in a fresh interpreter: jax reads its cache settings once
per process, and ``ensure_compilation_cache`` is process-global.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from waveformanalysis_tpu.foundation.compile_cache import (
    DEFAULT_CACHE_DIR, ensure_compilation_cache)
path = ensure_compilation_cache(force={force})
if {compile}:
    jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(7)))
print(json.dumps({{"path": path, "default": DEFAULT_CACHE_DIR,
                   "jax_dir": jax.config.jax_compilation_cache_dir}}))
"""


def _probe(env_dir, force, compile_):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "WFA_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    code = _PROBE.format(repo=str(REPO), force=force, compile=compile_)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_dir_is_the_only_cache_dir(tmp_path):
    cache = tmp_path / "xla"
    got = _probe(cache, force=False, compile_=True)
    assert got["path"] == str(cache)
    assert got["jax_dir"] == str(cache)
    assert any(cache.iterdir()), "no compiled entry written to the env dir"


def test_default_dir_is_fixed_inside_the_checkout():
    got = _probe(None, force=True, compile_=False)
    assert got["path"] == got["default"] == got["jax_dir"]
    assert got["default"] == str(REPO / ".jax_cache" / "xla")


@pytest.mark.parametrize("env_set", [False, True])
def test_cpu_is_opt_in_unless_the_env_names_a_dir(tmp_path, env_set):
    got = _probe(tmp_path / "xla" if env_set else None, force=False,
                 compile_=False)
    if env_set:
        assert got["path"] == str(tmp_path / "xla")
    else:
        assert got["path"] is None and got["jax_dir"] is None
