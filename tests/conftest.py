import os

# The suite runs on the CPU backend unless the caller names a platform:
# a virtual 8-device CPU mesh exercises the multi-device sharding without
# hardware.  Tests marked `gpu` run on the card with
# `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` and skip elsewhere
# (decided per test in the fixture below, never at import).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"].startswith("cpu"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from ac3acm_tpu.utils.cache import (enable_compile_cache,  # noqa: E402
                                    ensure_map_headroom, map_count,
                                    raise_stack_limit)

raise_stack_limit()
# XLA:CPU leaks ~3 mmaps per JIT'd fusion for as long as the executable
# lives; the full suite compiles enough to blow through the default
# vm.max_map_count=65530 and segfault mid-compile.  The ceiling is only
# raised when the runner opts in with AC3ACM_RAISE_MAP_COUNT=1 (a global
# kernel tunable should not change as a test side effect); otherwise the
# autouse fixture below sheds executables between modules when close.
ensure_map_headroom()

# persistent compile cache: CPU scan pipelines take ~1 min each to compile
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs",
                  float(os.environ.get("AC3ACM_CACHE_MIN_COMPILE_S", "1.0")))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _shed_executables_when_maps_high():
    """Guard against vm.max_map_count exhaustion (SIGSEGV in XLA compile).

    When the ceiling could not be raised (non-root), drop live executables
    between test modules once the process nears it; recompiles mostly hit
    the persistent cache."""
    yield
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            limit = int(f.read())
    except OSError:
        limit = 65530
    if map_count() > limit - 25000:
        jax.clear_caches()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` need the card: skip them on any other
    backend."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip(f"needs a GPU (backend is {jax.default_backend()}); "
                    "run with JAX_PLATFORMS=cuda python -m pytest tests/ "
                    "-m gpu")


@pytest.fixture
def eight_devices():
    """The 8-device virtual CPU mesh the sharding tests need."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
