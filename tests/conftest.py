"""Test configuration: force an 8-virtual-device CPU JAX backend.

Tests run on the CPU; the multi-device (shard_map) path is exercised on a
virtual 8-device CPU mesh. These env vars must be set before jax
initializes. Tests that need a GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when no GPU is present; run them
on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Debug cross-check: device scan packing verifies the kernel-packed bit
# count against the host prediction before trusting known_bits.
os.environ.setdefault("DMMT_CHECK_BITS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys
from pathlib import Path

import numpy as np
import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

REFERENCE_FIXTURES = Path("/root/reference/tests")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables at module boundaries: with ~400 tests
    compiling hundreds of XLA:CPU programs in one process, the LLVM JIT
    eventually abort()s inside backend_compile (reproducibly at the
    same late test, which passes in isolation). Bounding the live
    executable count keeps the suite stable; cross-module program reuse
    is minor (most modules compile their own shapes)."""
    yield
    jax.clear_caches()


# Round 3 showed module-boundary clearing is not enough: a single module
# (test_onedispatch) grew past the crash threshold on its own. The bound
# must be per PROCESS, so ALSO clear every N tests regardless of module.
# N=10 keeps parametrized neighbors sharing programs most of the time
# while keeping the live-executable count far below the observed crash
# zone (the heavy modules compile ~10-30 executables/test).
_CLEAR_EVERY_N_TESTS = 10
_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _bound_live_executables_per_process():
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % _CLEAR_EVERY_N_TESTS == 0:
        jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: the test runs only where JAX finds a GPU"
    )


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs, not at import."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (JAX found none)")
    return gpus[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def fixtures_dir():
    if not REFERENCE_FIXTURES.is_dir():
        pytest.skip("reference fixtures not available")
    return REFERENCE_FIXTURES
