"""Test configuration.

Tests run on CPU with 8 virtual devices so sharding/halo-exchange paths can
be exercised without accelerator hardware (SURVEY.md section 4, item 4),
unless JAX_PLATFORMS is already set.  Must set env before jax import.
Tests that need the GPU carry the ``gpu`` marker and skip without one
(the ``gpu_device`` fixture decides); on the card run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# If something imported jax before this file ran, the env var is read too
# late — also set the platform through the config API before any backend
# initializes.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX has none (decided here, at test
    time, so every worker collects the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/")
