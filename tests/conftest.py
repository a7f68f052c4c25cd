"""Test harness configuration.

Runs the whole suite on CPU with 8 virtual XLA devices so the sharding
logic is exercised without a GPU (SURVEY.md §4), and enables x64 so
SciPy/pandas parity oracles can assert <=1e-8. Tests that need the card
carry the ``gpu`` marker and skip here (``requires_gpu`` fixture).

Must set env vars before jax is imported anywhere.
"""

import os

# CPU unless the caller names a platform: chip_smoke.py runs the
# gpu-marked tests in its own process with JAX_PLATFORMS=cuda
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may have been imported before this conftest ran, so the env var
# alone is not enough — set the config directly.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# The suite is compile-dominated (hundreds of small jits at x64 on the
# 8-device virtual mesh); a persistent compilation cache cuts repeat runs
# by several-fold. A test-only directory inside the checkout, unless
# JAX_COMPILATION_CACHE_DIR names one.
from iv_engine import compile_cache  # noqa: E402

compile_cache.enable(os.path.join(compile_cache.DEFAULT_DIR, "tests"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def requires_gpu():
    """Skip unless a CUDA device is visible. Decided here, at run time,
    never at import: the suite is pinned to the CPU unless JAX_PLATFORMS
    says otherwise, and ``python chip_smoke.py`` runs the card-only
    tests on the GPU host."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a CUDA GPU (run python chip_smoke.py on the card)")
    return gpus[0]
