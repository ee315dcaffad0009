"""Platform plumbing: compile-cache location, device peaks, device memory
and the per-platform route functions."""

import os
from types import SimpleNamespace

import jax
import pytest

from kvmatch_tpu.engine.base import dense_emit_for
from kvmatch_tpu.parallel import query as pq
from kvmatch_tpu.utils import compile_cache, kernel_bench


def test_compile_cache_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(compile_cache.__file__))))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_peaks_known_device():
    pk = kernel_bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["f32_flops_per_s"] == 67e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "AMD Instinct MI300X", ""])
def test_peaks_unknown_device_raises(kind):
    with pytest.raises(ValueError):
        kernel_bench.peaks_for(kind)


def test_roofline_share_takes_the_binding_bound():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB in 2 ms: the bandwidth floor is 1 ms -> share 0.5
    assert kernel_bench.roofline_share(kind, 2e-3, nbytes=3.35e9) == \
        pytest.approx(0.5)
    # 67 GFLOP in 1 ms against a 0.1 ms byte floor -> compute binds
    assert kernel_bench.roofline_share(kind, 1e-3, nbytes=3.35e8,
                                       flops=67e9) == pytest.approx(1.0)


class _FakeDevice(SimpleNamespace):
    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize("platform,stats,want", [
    ("gpu", {"bytes_limit": 60 << 30}, 60 << 30),
    ("gpu", {"bytes_limit": 7 << 30, "bytes_in_use": 1}, 7 << 30),
    ("cpu", None, pq.CPU_DEVICE_MEM_BYTES),
    ("cpu", {"bytes_limit": 1 << 40}, pq.CPU_DEVICE_MEM_BYTES)])
def test_device_mem_bytes(platform, stats, want):
    dev = _FakeDevice(platform=platform, device_kind="fake", stats=stats)
    assert pq._device_mem_bytes(dev) == want


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_device_mem_bytes_raises_without_limit(stats):
    dev = _FakeDevice(platform="gpu", device_kind="fake", stats=stats)
    with pytest.raises(RuntimeError):
        pq._device_mem_bytes(dev)


def test_device_mem_bytes_cpu_default():
    assert pq._device_mem_bytes() == pq.CPU_DEVICE_MEM_BYTES


@pytest.mark.parametrize("platform,route", [("gpu", "flags"),
                                            ("cpu", "runs")])
def test_dense_emit_for(platform, route):
    assert dense_emit_for(platform) == route


def test_dense_emit_for_unknown_platform():
    with pytest.raises(ValueError):
        dense_emit_for("metal")
