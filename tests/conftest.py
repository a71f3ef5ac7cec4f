"""Test harness: run everything on a virtual 8-device CPU mesh.

Must run before jax is imported anywhere (multi-device behavior is
validated with --xla_force_host_platform_device_count, no real cards
needed). Tests that need a GPU carry the ``gpu`` marker and skip here.
"""

import os

import pytest

# Force CPU: tests always run on a virtual 8-device CPU mesh, even on a
# machine with a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_threefry_partitionable", True)

# Persistent compilation cache: repeat test runs skip recompiles (the
# suite is compile-dominated).
from raytracinginoneweekend_tpu.utils.compilecache import (  # noqa: E402
    enable_persistent_cache)

enable_persistent_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided at run time, never at import:
    every xdist worker must collect the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run python chip_smoke.py on the card")
