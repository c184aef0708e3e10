"""Test configuration: the JAX CPU backend with 8 virtual devices.

Tests run on the CPU so CI needs no hardware; GPU kernels run there through
the Pallas interpreter, and multi-device sharding tests use the 8-device
virtual host platform. This must happen before jax initializes a backend,
hence the env mutation at import time. Tests marked ``gpu`` need a card;
run them on one with ``WFA_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``.
"""

import os
import sys

# Force-override any platform preset in the environment: unit tests must
# never grab an accelerator unless asked to (WFA_TEST_PLATFORM=gpu).
_PLATFORM = "gpu" if os.environ.get("WFA_TEST_PLATFORM") == "gpu" else "cpu"
os.environ["JAX_PLATFORMS"] = "cuda" if _PLATFORM == "gpu" else "cpu"
os.environ["JAX_PLATFORM_NAME"] = _PLATFORM
_flags = os.environ.get("XLA_FLAGS", "")
if _PLATFORM == "cpu" and "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Make the repo root importable without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import or collection time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels have no CPU "
                    "lowering (their interpret-mode twins run here)")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def tmp_context(tmp_path):
    """A real Context over tmp_path storage (reference analog:
    tests/conftest.py:62-76)."""
    from waveformanalysis_tpu.context.context import Context

    return Context(
        storage_dir=str(tmp_path / "storage"),
        config={"show_progress": False},
    )
