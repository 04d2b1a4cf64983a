"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on an 8-device host-platform mesh
(SURVEY.md §4) via XLA_FLAGS, set BEFORE jax is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from visionx_slam_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(42)
