"""utils.cache: one compile-cache directory rule for every entry point."""
import os

from ac3acm_tpu.utils import cache


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache on every
    platform -- no per-machine subdirectory, nothing else."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    for platform in ("cpu", "gpu"):
        assert cache.compile_cache_dir(platform) == str(tmp_path)


def test_cache_dir_default_is_fixed(monkeypatch):
    """Unset: <repo>/.jax_cache for the GPU, plus a machine-fingerprint
    subdirectory on the CPU only; the same path on every call (no pid,
    time or temporary name in it)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.join(repo, ".jax_cache")
    assert cache.compile_cache_dir("gpu") == base
    cpu = cache.compile_cache_dir("cpu")
    assert os.path.dirname(cpu) == base
    assert os.path.basename(cpu) == cache.machine_fingerprint()
    assert cache.compile_cache_dir("cpu") == cpu
