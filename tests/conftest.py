"""Test env: CPU with 8 virtual devices, so sharding paths run anywhere.

The CPU is used unless JAX_PLATFORMS names another platform explicitly (it
must be set before the backend initializes — pytest imports conftest before
any test module).  Tests that need a CUDA GPU carry the ``gpu`` marker, take
the ``gpu`` fixture below and skip on the CPU; chip_smoke.py runs them on the
card with ``JAX_PLATFORMS=cuda pytest -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

# Persistent XLA compile cache (gato_tpu.compile_cache): the suite is
# dominated by one-time CPU compiles.
from gato_tpu import compile_cache  # noqa: E402

compile_cache.enable()


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU compile time degrades as a single process accumulates live
    executables (measured: the same test compiles 11 s in a fresh process vs
    32 s late in the suite).  Compiled programs are rarely shared across test
    modules (different shapes), so dropping them at each module boundary
    keeps every file near its fresh-process compile speed; the persistent
    .jax_cache still serves repeat compiles across modules and runs."""
    yield
    import jax as _jax

    _jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless a CUDA GPU is the default device.  Decided here, inside a
    fixture, never at import: every xdist worker must collect the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run chip_smoke.py on the card)")


H100 = ("gpu", "NVIDIA H100 80GB HBM3")


@pytest.fixture
def as_h100(monkeypatch):
    """Make dispatch.choose_backend see an H100, with the Triton kernel run
    in the Pallas interpreter: the GPU's dispatch decisions and the kernel's
    arithmetic, exercised on the CPU.  Returns a callable that restores the
    real device for the rest of the test."""
    import functools

    from gato_tpu import dispatch
    from gato_tpu.kernels import pcg_triton as pt

    monkeypatch.setattr(dispatch, "current_device", lambda: H100)
    monkeypatch.setattr(pt, "pcg_triton",
                        functools.partial(pt.pcg_triton, interpret=True))
    jax.clear_caches()
    yield monkeypatch.undo
    jax.clear_caches()
