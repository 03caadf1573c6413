"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the SURVEY.md §4 strategy — oracle tests vs NumPy references, with
multi-device parity checked by running the same programs on a simulated
mesh (XLA_FLAGS=--xla_force_host_platform_device_count).
"""

import os

import jax

# Tests run on the CPU, with an 8-device virtual mesh so multi-device
# sharding is exercised without hardware; the Pallas kernels run in
# interpret mode there.  Only an explicit JAX_PLATFORMS (e.g. "cuda", for
# the tests marked `gpu`) selects another platform.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_memory_between_modules():
    """Free compiled executables between test modules: the full suite
    (8 virtual devices) accumulates enough XLA-CPU state to run out of
    memory on a small host in one process.  Per-module recompiles cost a
    couple of minutes in total."""
    yield
    jax.clear_caches()
