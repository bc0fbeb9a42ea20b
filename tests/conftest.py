"""Test config: the CPU with an 8-device virtual mesh (idiomatic JAX
substitute for multi-device testing; see SURVEY.md §4).

GPU lane: ``python -m pytest -m gpu -n 0 tests/`` on a machine with an
NVIDIA GPU keeps the real backend and runs only the ``gpu``-marked tests
(kernels compiled for the card, compared with their plain references).
Whether a card is present is decided by the ``gpu_device`` fixture: the
same tests are collected everywhere, and on the CPU they skip.
"""

import os

import pytest

# fail fast instead of retrying network fetches (loaders fall back offline)
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402


def _gpu_lane(config) -> bool:
    return (config.getoption("markexpr") or "").strip() == "gpu"


def pytest_configure(config):
    if _gpu_lane(config):
        if os.environ.get("PYTEST_XDIST_WORKER"):
            raise pytest.UsageError(
                "the GPU lane holds the card in one process: run it with "
                "-n 0")
        from kvzip_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        return
    # before any backend is initialized
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


def pytest_collection_modifyitems(config, items):
    # run the multi-device tests FIRST (fresh XLA state)
    items.sort(key=lambda it: 0 if "test_parallel" in it.nodeid else 1)


@pytest.fixture
def gpu_device():
    """The GPU, or a skip where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu -n 0")
    return dev
