"""Test configuration: JAX on the CPU with 8 virtual devices.

Multi-device sharding paths run on the virtual CPU mesh. Tests marked
``gpu`` compile for the card; they skip here, inside the ``gpu_device``
fixture, and run on a GPU machine with

    MAZU_TEST_PLATFORM=gpu python -m pytest tests -m gpu -q
"""

import os

ON_GPU = os.environ.get("MAZU_TEST_PLATFORM") == "gpu"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

REFERENCE_DIR = os.environ.get("MAZU_REFERENCE_DIR", "/root/reference")
TEST_DATA = os.path.join(REFERENCE_DIR, "test_data")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def test_data_dir():
    if not os.path.isdir(TEST_DATA):
        pytest.skip("reference test_data not available")
    return TEST_DATA


@pytest.fixture(scope="session")
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform here: {dev.platform})")
    return dev
