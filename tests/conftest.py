"""Test harness configuration.

The suite runs on the CPU backend with 8 virtual devices, so the multi-device
sharding tests (a ``jax.sharding.Mesh`` over 8 devices) run without a GPU.
JAX is pinned to the CPU through ``jax.config`` before any backend starts.

Tests that need a card carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them on the CPU.  Run them on a GPU machine with the
CPU pinning turned off:

    DEFLATE_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ON_GPU = os.environ.get("DEFLATE_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert all(d.platform == "cpu" for d in jax.devices())
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices for mesh tests"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (see the gpu_device fixture)")


@pytest.fixture
def gpu_device():
    """The first JAX device, or a skip when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX runs on {dev.platform}); run with "
            "DEFLATE_TESTS_ON_GPU=1 on a GPU machine")
    from deflate_rs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return dev
