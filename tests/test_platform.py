"""Platform plumbing: which engine and backends run where, the memory
budget rule, the compile-cache location and the plain-jnp unpack."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from damapper_tpu.ops import device_index as dix
from damapper_tpu.pipeline import mapper
from damapper_tpu.utils import cache, memory


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self.process_index = 0

    def memory_stats(self):
        return {}


@pytest.mark.parametrize("platform,ffi", [("gpu", "cuda"), ("cpu", "cpu"),
                                          ("rocm", None)])
def test_device_engine_per_platform(monkeypatch, platform, ffi):
    """The device wave engine runs the CUDA kernel on a GPU, its host build
    on the CPU, and refuses any other platform."""
    from damapper_tpu.ops import wave_kernel
    from damapper_tpu.ops.spec import new_align_spec

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform)])
    monkeypatch.setattr(wave_kernel, "register", lambda p: None)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    if ffi is None:
        with pytest.raises(ValueError, match="no wave kernel"):
            wave_kernel.KernelWaveEngine(spec)
    else:
        assert wave_kernel.KernelWaveEngine(spec)._ffi == ffi


@pytest.mark.parametrize("platform,wave,index", [("gpu", "device", "device"),
                                                 ("cpu", "oracle", "host"),
                                                 ("rocm", None, None)])
def test_auto_backends_per_platform(monkeypatch, platform, wave, index):
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform)])
    if wave is None:
        with pytest.raises(RuntimeError, match="unsupported"):
            mapper._auto_backend()
        with pytest.raises(RuntimeError, match="unsupported"):
            mapper._auto_index()
    else:
        assert mapper._auto_backend() == wave
        assert mapper._auto_index() == index


def test_device_memory_budget(monkeypatch):
    """Budgets are shares of the device's memory: physical memory on the
    CPU, the allocator's limit elsewhere, and an error where none is
    reported."""
    assert memory.device_memory() == memory.physical_memory()
    assert memory.device_share(0.25) == memory.physical_memory() // 4
    gpu = _FakeDevice("gpu")
    with pytest.raises(RuntimeError, match="no memory limit"):
        memory.device_memory(gpu)
    monkeypatch.setattr(gpu, "memory_stats",
                        lambda: {"bytes_limit": 60 << 30})
    assert memory.device_share(0.5, gpu) == 30 << 30


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(cache, "DEFAULT_DIR", tmp_path / "default")
    got = cache.enable_compile_cache()
    assert got == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "default").exists()


def test_compile_cache_default_in_checkout(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(cache.DEFAULT_DIR) == os.path.join(
        repo, "damapper_tpu", "build", "xla_cache")
    monkeypatch.setattr(cache, "DEFAULT_DIR", tmp_path / "xla")
    try:
        assert cache.enable_compile_cache() == str(tmp_path / "xla")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")
        assert (tmp_path / "xla").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("path", ["single", "scan"])
def test_unpack_matches_packed_sequence(monkeypatch, path):
    """The on-device unpack (plain integer broadcast, shift and mask)
    restores every base of pack_seq's input and a sentinel 4 outside
    each read, through the single-shot path and the chunked scan."""
    rng = np.random.default_rng(3)
    cap = 8192
    seq = np.full(6000, 4, np.uint8)
    starts, ends, pos = [], [], 1
    while pos < 5900:
        ln = int(rng.integers(30, 700))
        end = min(pos + ln, 5900)
        seq[pos:end] = rng.integers(0, 4, end - pos)
        starts.append(pos)
        ends.append(end)
        pos = end + 1
    s = np.zeros(256, np.int32)
    e = np.zeros(256, np.int32)
    s[:len(starts)] = starts
    e[:len(ends)] = ends
    monkeypatch.setattr(dix, "_unpack_single_shot_max",
                        lambda: cap if path == "single" else 0)
    monkeypatch.setattr(dix, "_UNPACK_CL", 1024)
    got = np.asarray(dix.unpack_seq_dev(jnp.asarray(dix.pack_seq(seq, cap)),
                                        jnp.asarray(s), jnp.asarray(e)))
    want = np.full(cap, 4, np.uint8)
    want[:len(seq)] = seq
    np.testing.assert_array_equal(got, want)


def test_ref_seq_cache_keys_and_disable(monkeypatch, tmp_path):
    """The align-sequence cache serves a hit only for the same upload
    format, and DAMAPPER_REFCACHE=0 always uploads afresh."""
    from damapper_tpu.pipeline import reporter

    (tmp_path / "ref.bps").write_bytes(b"")

    class DB:
        path = str(tmp_path / "ref")
        part = 0
        totlen = 8
        seq = np.zeros(8, np.uint8)
        reads = {"boff": np.zeros(1, np.int64), "rlen": np.full(1, 8)}

    uploads = []

    def upload(seq, boff, rlen):
        uploads.append(np.zeros(16, np.uint8))
        return uploads[-1]

    monkeypatch.delenv("DAMAPPER_REFCACHE", raising=False)
    monkeypatch.delenv("DAMAPPER_PACK_UPLOAD", raising=False)
    reporter._ref_seq_cache.clear()
    try:
        first = reporter._ref_seq_cached(upload, DB)
        assert reporter._ref_seq_cached(upload, DB) is first
        monkeypatch.setenv("DAMAPPER_PACK_UPLOAD", "0")
        plain = reporter._ref_seq_cached(upload, DB)
        assert plain is not first and len(uploads) == 2
        monkeypatch.setenv("DAMAPPER_REFCACHE", "0")
        assert reporter._ref_seq_cached(upload, DB) is not plain
        assert len(uploads) == 3
    finally:
        reporter._ref_seq_cache.clear()
