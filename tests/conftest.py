"""Test harness: run everything on CPU with 8 virtual devices.

This is the standard JAX trick for testing multi-device sharding on one
host (SURVEY.md section 4): env vars must be set before jax initializes.
Tests marked `gpu` need the card; they skip here and run on the card
through `python chip_smoke.py`.
"""

import os

# The card's own tests (marker `gpu`) are run with JAX_PLATFORMS=cuda,cpu by
# chip_smoke.py; everything else runs on the host CPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import photobundle_tpu  # noqa: E402,F401  (sets the compile cache dir)

# The CPU suite compiles hundreds of small programs; keep them out of the
# checkout's persistent cache.
jax.config.update("jax_enable_compilation_cache", False)

if os.environ["JAX_PLATFORMS"] == "cpu":
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU devices"
    assert len(jax.devices()) == 8, "conftest expects 8 virtual CPU devices"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips where there is none (decided at run time, so
    every xdist worker collects the same tests)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU; runs on the card via chip_smoke.py")
    return devs[0]
