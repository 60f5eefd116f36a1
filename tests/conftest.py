"""Test fixture: force the CPU platform with 8 virtual devices.

≙ the reference CI installing mesa software Vulkan (lavapipe) to run real WGSL
kernels without a GPU (the reference's `.github/workflows/ci.yml:17-21`); here the
same trick is `--xla_force_host_platform_device_count=8` so sharding/mesh tests
exercise real XLA collectives on 8 virtual CPU devices (SURVEY.md §4).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def device():
    import arrow_tpu as at

    return at.default_device()
