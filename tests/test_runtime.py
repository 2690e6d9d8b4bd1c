"""Runtime plumbing: compile-cache placement, device guards, the bench's peak
table, the device-cache budget, and the CPU-only dryrun re-exec."""

import os.path as osp
import types

import jax
import pytest

from demo2program_tpu.cli import _jax_setup
from demo2program_tpu.train import device_cache


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _jax_setup.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = _jax_setup.compile_cache_dir()
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    assert path == osp.join(root, ".jax_cache")
    with open(osp.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_smoke_requires_gpu_backend():
    import chip_smoke
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="only on an NVIDIA GPU"):
        chip_smoke.require_gpu(jax)


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
])
def test_peak_lookup(kind, peak):
    import bench
    got, reason = bench.peak_flops(kind)
    assert got == peak
    assert (reason is None) == (peak is not None)
    if reason:
        assert kind in reason


class _FakeDevice:
    platform, device_kind = "gpu", "fake"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_budget_from_memory_stats():
    dev = _FakeDevice({"bytes_limit": 60 * 2 ** 30, "bytes_in_use": 0})
    assert device_cache.device_budget_bytes(dev) \
        == 60 * 2 ** 30 * device_cache.CACHE_MEMORY_FRACTION


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_device_budget_raises_without_limit(stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        device_cache.device_budget_bytes(_FakeDevice(stats))


def test_cpu_device_has_no_budget():
    assert device_cache.device_budget_bytes(jax.devices("cpu")[0]) is None


def test_dryrun_raises_on_too_few_accelerators(monkeypatch):
    import __graft_entry__ as ge
    fake = types.SimpleNamespace(device_count=lambda: 1,
                                 default_backend=lambda: "gpu")
    monkeypatch.setitem(__import__("sys").modules, "jax", fake)
    called = []
    monkeypatch.setattr(ge, "run_on_virtual_cpu_mesh", called.append)
    with pytest.raises(RuntimeError, match="needs 4 gpu devices"):
        ge.dryrun_multichip(4)
    assert called == []


def test_dryrun_reexecs_only_on_cpu(monkeypatch):
    import __graft_entry__ as ge
    fake = types.SimpleNamespace(device_count=lambda: 1,
                                 default_backend=lambda: "cpu")
    monkeypatch.setitem(__import__("sys").modules, "jax", fake)
    called = []
    monkeypatch.setattr(ge, "run_on_virtual_cpu_mesh", called.append)
    ge.dryrun_multichip(4)
    assert called == [4]
