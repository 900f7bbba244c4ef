"""Persistent jit compilation cache: one directory rule for every entry
point (tests, bench.py, chip_smoke.py, tools).

  * JAX_COMPILATION_CACHE_DIR, when set, is the cache -- nothing else is
    set in code;
  * otherwise <repo>/.jax_cache, with a per-machine subdirectory on the
    CPU backend only.

The persistent XLA compile cache key does not cover the host CPU's feature
set: an XLA:CPU AOT artifact compiled on one machine can be loaded on
another with different features, where it warns about feature mismatch and
can crash outright (observed: SIGSEGV in cpu_aot_loader deserialization
when the compile machine had +prefer-no-scatter/+amx-* and the execution
host did not).  CPU caches are therefore partitioned by a machine
fingerprint, so each host only ever loads its own artifacts.
"""
from __future__ import annotations

import hashlib
import os


def machine_fingerprint() -> str:
    """Hash of the codegen-relevant CPU identity.

    The whole first /proc/cpuinfo processor block (minus per-boot noise:
    MHz, bogomips, core ids) goes in, not just the `flags` line: LLVM
    picks target tuning features from the CPU *model* (e.g.
    prefer-no-gather on gather-downclocking parts), so two hosts with
    identical flags can still produce float-divergent XLA:CPU AOT
    artifacts.  Observed: a foreign cached executable and a fresh
    compile of the same HLO disagreeing by 1 ulp in f32 matmuls."""
    parts = []
    try:
        import jaxlib
        parts.append(getattr(jaxlib, "__version__", "?"))
    except Exception:
        parts.append("nojaxlib")
    volatile = ("cpu mhz", "bogomips", "processor", "core id",
                "apicid", "initial apicid", "siblings", "cpu cores")
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                        # end of first block
                if line.split(":")[0].strip().lower() in volatile:
                    continue
                parts.append(line.strip())
    except OSError:
        import platform
        parts.append(platform.processor() or platform.machine())
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


def raise_stack_limit(soft_bytes: int = 512 * 2 ** 20) -> None:
    """Raise the main-thread stack soft limit (default 512 MB).

    Serializing the largest compiled executables (the fused encode+pack
    pipeline's HLO) recurses deeply enough in the cache writer to overflow
    the default 8 MB stack -- observed as SIGSEGV inside
    compilation_cache.put/get_executable_and_time.  The hard limit is
    normally unlimited, so the soft limit can simply be raised.
    """
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
        want = soft_bytes if hard == resource.RLIM_INFINITY \
            else min(soft_bytes, hard)
        if soft != resource.RLIM_INFINITY and soft < want:
            resource.setrlimit(resource.RLIMIT_STACK, (want, hard))
    except Exception:
        pass                      # best effort; platform may refuse


def map_count() -> int:
    """Number of memory mappings of this process (0 if unreadable)."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def ensure_map_headroom(want: int = 1 << 20) -> None:
    """Raise vm.max_map_count when permitted AND explicitly opted in.

    XLA:CPU emits ~3 mappings per JIT'd fusion and never unmaps while the
    executable lives; a long test session accumulates tens of thousands of
    maps and dies with SIGSEGV inside compile/serialize when mmap starts
    failing at the default 65530 limit.

    Writing a system-wide kernel tunable from test setup can surprise
    shared hosts, so the write only happens when AC3ACM_RAISE_MAP_COUNT=1
    is set (and is logged when it fires).  Without the opt-in, callers
    shed executables (jax.clear_caches) when map_count() approaches the
    ceiling -- see tests/conftest.py's autouse fixture.
    """
    if os.environ.get("AC3ACM_RAISE_MAP_COUNT") != "1":
        return
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            cur = int(f.read())
        if cur < want:
            with open("/proc/sys/vm/max_map_count", "w") as f:
                f.write(str(want))
            import logging
            logging.getLogger("ac3acm_tpu").info(
                "raised vm.max_map_count %d -> %d "
                "(AC3ACM_RAISE_MAP_COUNT=1)", cur, want)
    except OSError:
        pass


REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(platform: str) -> str:
    """The cache directory for a process on `platform` ("cpu", "gpu",
    ...): JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache
    (plus /<fingerprint> on the CPU)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if platform == "cpu":
        return os.path.join(REPO_CACHE, machine_fingerprint())
    return REPO_CACHE


def enable_compile_cache(platform: str | None = None) -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() for
    this process's platform (default: jax.default_backend()) and return
    the directory."""
    import jax
    path = compile_cache_dir(platform or jax.default_backend())
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
