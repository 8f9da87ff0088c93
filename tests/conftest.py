"""Test environment: CPU backend with 8 virtual devices, x64 enabled.

Multi-device sharding semantics are exercised on a simulated device mesh
(SURVEY.md §4(f)): XLA's host platform is forced to expose 8 devices, which
lets `shard_map`/`pjit` tests run anywhere.  x64 is enabled so the engine can
be run in f64 for near-bitwise comparison against the numpy oracle (the GPU
production path is f32).  Pallas kernels run in the interpreter here.

Tests marked ``gpu`` need the card and skip elsewhere; `chip_smoke.py` runs
them on the GPU (there ``JAX_PLATFORMS=cuda`` keeps the real backend).

NOTE: the installed `jaxtyping` pytest plugin imports jax before this
conftest executes, so plain env-var settings for JAX_ENABLE_X64 would be
read too late.  `jax.config.update` works after import (backends are only
initialized on first use), and XLA_FLAGS is read at backend init, so
setting it here is still early enough.
"""

import os

import pytest

_PLATFORMS = os.environ.get("JAX_PLATFORMS", "cpu").split(",")
if "cuda" in _PLATFORMS or "gpu" in _PLATFORMS:
    import jax  # noqa: F401  (on the card: keep the GPU backend, f32)
else:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests unless JAX runs on a GPU — decided here,
    at run time, never while test modules are imported."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card via chip_smoke.py)")
