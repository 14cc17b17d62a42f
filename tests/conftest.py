"""Test harness config: force a genuine multi-device CPU backend.

The suite runs on the CPU, with several xdist workers, none of which may
open the GPU: ``jax.config.update`` before the first backend
initialization pins JAX to the CPU whatever ``JAX_PLATFORMS`` says.  8
virtual CPU devices give the JAX-native "fake backend" for multi-device
tests (SURVEY.md §4).

Tests that need the GPU carry the ``gpu`` marker and the ``gpu`` fixture,
which skips them here.  They run on the card with ``RAYTRACER_TEST_GPU=1``
(see README: ``python chip_smoke.py`` runs them), which leaves the platform
to JAX.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

ON_GPU = os.environ.get("RAYTRACER_TEST_GPU") == "1"
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop XLA executable/tracing caches after each test module.

    The full suite performs ~300 in-process XLA:CPU compiles; without
    this, pytest deterministically segfaulted inside
    ``backend_compile_and_load`` at test #305 (VERDICT r4 weak #2) while
    every test passed when its file ran alone.  Session-scoped fixtures
    (compiled renders cached on scene identity) survive — only dead
    executables are released."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def default_world():
    import raytracer_tpu as rt
    return rt.models.default_world()


@pytest.fixture(scope="session")
def ffi_world():
    import raytracer_tpu as rt
    return rt.models.ffi_example_world()


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the "
                    "card")
