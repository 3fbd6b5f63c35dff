"""Test configuration: CPU backend, 8 virtual devices, float64 parity mode.

The analog of the reference's test substitutions (SQLite for TimescaleDB,
mock brokers, mock metrics — SURVEY.md section 4): tests run on a virtual
8-device CPU mesh so multi-device sharding logic is exercised without
hardware, and with x64 enabled so numerical parity against the C++
reference semantics (1e-8 price / 1e-6 implied vol) is meaningful.  Pallas
kernels run in interpret mode; tests that need the GPU itself carry the
``gpu`` marker and skip here (run them with ``python chip_smoke.py``).
"""

import os

# Must be set before jax is imported anywhere in the test process.  Force CPU
# even on a machine with a GPU: the test-suite is the float64 parity /
# virtual-mesh harness, the GPU is the chip_smoke/bench path.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Belt and braces: if a pytest plugin imported jax before this conftest ran,
# the env var above was too late — flip the config knobs directly too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the suite is compile-bound on CPU (PDE
# marches, shard_map programs, the jitted calibration pipeline), and the
# cache survives processes — repeat runs skip most of that cost (measured
# ~4x on the ADI march).  JAX_COMPILATION_CACHE_DIR wins when it is set.
# Safe to delete at any time.
from pde_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(os.path.join(os.path.dirname(__file__), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_xla_memory_maps():
    """Keep the process under vm.max_map_count.

    Every compiled XLA executable mmaps multiple regions; a full-suite run
    accumulates 60k+ maps and SEGFAULTS (inside XLA compile or cache
    deserialize — whichever mmaps next) once it crosses the kernel default
    ``vm.max_map_count = 65530``.  Diagnosed by sampling /proc/self/maps:
    the count climbs ~200/executable and the crash lands exactly at the
    limit, always at the same point in suite order.  Dropping the jit
    caches between modules unloads executables and frees the maps; the
    persistent disk cache (above) makes later recompiles cheap.
    """
    yield
    try:
        with open("/proc/self/maps", "rb") as f:
            n_maps = sum(1 for _ in f)
    except OSError:
        return
    if n_maps > 40_000:
        jax.clear_caches()
        import gc

        gc.collect()


@pytest.fixture()
def rng(request):
    """Per-test, order-independent RNG.

    A session-scoped generator makes every statistical test's sample depend
    on which tests ran before it — a 95%-confidence test then flakes on ~5%
    of orderings (this bit test_kupiec_backtest in round 1).  Seeding from
    the test's node id gives each test the SAME draws on every run and
    every ordering.
    """
    import zlib

    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture(scope="session")
def heston_test_params():
    """The canonical parameter set used throughout the reference tests
    (benchmarks/python_vs_cpp.py:50, tests/cpp/test_heston.cpp)."""
    from pde_tpu.models.heston import HestonParams

    return HestonParams(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)


@pytest.fixture(scope="session")
def market():
    return dict(spot=100.0, rate=0.05, dividend=0.02)
