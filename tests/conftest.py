"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the `hwsim` analog — SURVEY.md §4):
JAX is forced onto the host platform with 8 virtual devices BEFORE the first
jax import, so sharding tests exercise real multi-device code paths without
a GPU. Tests marked ``gpu`` need the card: the ``gpu_device`` fixture skips
them here; chip_smoke.py runs the same paths on the GPU.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# The reference repo's canonical smoke-test matrix (read-only mount); tests
# that need it skip gracefully if the mount is absent.
NASA4704 = Path("/root/reference/matrices/nasa4704/nasa4704.mtx")


@pytest.fixture(scope="session")
def nasa4704_path():
    if not NASA4704.exists():
        pytest.skip("reference nasa4704.mtx not available")
    return NASA4704


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py covers this path on the card")
    return dev
