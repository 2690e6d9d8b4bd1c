"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so the multi-device
sharding logic (parallel/mesh.py, the data-parallel train step) is
exercised without accelerators — the JAX-native way to test a mesh
(SURVEY.md §4). Tests that need an NVIDIA GPU carry the `gpu` marker, skip
here, and run on the card inside `python chip_smoke.py`.

Must run before jax initializes its backends, hence env vars set at import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# persistent compile cache: the model-stack scans are expensive to compile on
# CPU; caching cuts repeat suite runs to seconds
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache", "tests"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

assert jax.device_count() >= 8, (
    "tests require the 8-device virtual CPU mesh; got "
    f"{jax.devices()}")


def pytest_configure(config):
    # test tiering: `pytest -m "not slow"` is the fast gate; the full suite
    # runs the heavy model-stack / trainer-e2e compiles too
    config.addinivalue_line(
        "markers",
        "slow: heavy model/e2e tests (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped on CPU, run by chip_smoke.py")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")
