"""Test configuration: CPU backend with 8 virtual devices and x64 enabled.

The virtual 8-device mesh lets the DP/chain-sharding logic be exercised
without accelerator hardware (cf. SURVEY.md §4); x64 matches the
reference's CPU numerics so tolerance-based parity tests are meaningful.
The platform is set through ``jax.config`` after import, which holds even
when the caller's environment names another backend.
"""

import os

import jax

if os.environ.get("MELLON_GPU_TESTS"):
    # accelerator-contract mode (``-m gpu``): keep the real backend and its
    # f32 numerics — forcing the CPU would hide exactly what those tests
    # check
    pass
else:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_xla_caches_between_modules():
    """Free XLA compile caches after each test module.

    A single-process full-suite run accumulates enough compiled-program
    state on the XLA CPU backend to segfault inside
    ``backend_compile_and_load`` at ~80% of the suite (round-4 weak #6;
    the failing test passes in isolation).  Dropping the caches at module
    boundaries bounds the live-executable set; individual modules
    recompile their shared fixtures at most once."""
    yield
    jax.clear_caches()
