"""Measured native-C++ vs JAX comparison on THIS machine.

Role parity with the reference's benchmarks/python_vs_cpp.py (SURVEY.md §6):
instead of quoting the reference's constants, run the same workloads through
this repo's own -O3 C++ host library (src/cpp/pde_host.cpp, the float64
oracle used by the parity tests) and through the JAX device path, and print
the measured ratio. One JSON line per workload.

    python scripts/native_vs_jax.py        # device = whatever JAX picks
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def _pull(x):
    import jax

    leaf = jax.tree_util.tree_leaves(x)[0]
    return float(np.asarray(leaf).ravel()[0])


def time_host(fn, n=10):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    return (time.perf_counter() - t0) / n


def time_device(fn, n=50):
    """Transfer-forced differencing (docs/performance.md)."""
    _pull(fn())

    def run(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = fn()
        _pull(out)
        return time.perf_counter() - t0

    t2, tn = run(2), run(n + 2)
    return max((tn - t2) / n, 1e-12)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from pde_tpu import native
    from pde_tpu.models import ou
    from pde_tpu.ops.tridiag import thomas

    if not native.is_available():
        print(json.dumps({"error": "native library unavailable"}))
        return 1

    print(f"# device={jax.devices()[0]}", file=sys.stderr)
    rng = np.random.default_rng(0)

    # 1. batched tridiagonal solve: 4096 systems x 128 points
    B, n = 4096, 128
    lower = rng.uniform(-0.4, -0.1, (B, n - 1))
    upper = rng.uniform(-0.4, -0.1, (B, n - 1))
    diag = 2.0 + rng.uniform(0, 1, (B, n))
    rhs = rng.uniform(-1, 1, (B, n))
    t_cpp = time_host(lambda: native.thomas_solve(lower, diag, upper, rhs))
    args32 = [jnp.asarray(a, jnp.float32) for a in (lower, diag, upper, rhs)]
    jfn = jax.jit(lambda a, b, c, d: thomas(a, b, c, d))
    t_jax = time_device(lambda: jfn(*args32))
    print(json.dumps({"metric": "thomas_4096x128_native_vs_jax",
                      "native_s": round(t_cpp, 6), "jax_s": round(t_jax, 6),
                      "speedup": round(t_cpp / t_jax, 1)}))

    # 2. OU MLE: 4096 paths x 252 obs (C++ loops per path; JAX vmaps)
    n_paths = 4096
    paths = np.cumsum(rng.normal(0, 0.1, (n_paths, 252)), axis=1) + 100.0
    t_cpp = time_host(
        lambda: [native.ou_mle(p, 1 / 252) for p in paths], n=3
    )
    jp = jnp.asarray(paths, jnp.float32)
    jfit = jax.jit(lambda xs: jax.vmap(lambda x: ou.fit_mle(x, 1 / 252).params.mu)(xs))
    t_jax = time_device(lambda: jfit(jp), n=20)
    print(json.dumps({"metric": "ou_mle_4096x252_native_vs_jax",
                      "native_s": round(t_cpp, 6), "jax_s": round(t_jax, 6),
                      "speedup": round(t_cpp / t_jax, 1)}))

    # 3. Heston Carr-Madan pricing: the reference's STAR workload
    # (benchmarks/python_vs_cpp.py: "10,000+ options/sec" C++). Native runs
    # the per-option 1024-point loop; JAX prices the same batch as one
    # tensor op on device.
    from pde_tpu.models import heston

    nopt = 512
    Kh = np.linspace(70.0, 130.0, nopt)
    Th = np.tile(np.linspace(0.1, 2.0, 8), nopt // 8)
    ich = (np.arange(nopt) % 2).astype(float)
    t_cpp = time_host(
        lambda: native.heston_price_batch(
            2.0, 0.04, 0.3, -0.7, 0.04, 100.0, 0.05, 0.02, Kh, Th, ich
        ),
        n=3,
    )
    hp = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    Kj, Tj = jnp.asarray(Kh, jnp.float32), jnp.asarray(Th, jnp.float32)
    icj = jnp.asarray(ich) > 0.5
    jprice = jax.jit(
        lambda K, T, ic: heston.price_carr_madan(hp, K, T, 100.0, 0.05, 0.02, is_call=ic)
    )
    t_jax = time_device(lambda: jprice(Kj, Tj, icj), n=30)
    print(json.dumps({"metric": "heston_price_512_native_vs_jax",
                      "native_s": round(t_cpp, 6), "jax_s": round(t_jax, 6),
                      "native_options_per_sec": round(nopt / t_cpp),
                      "jax_options_per_sec": round(nopt / t_jax),
                      "speedup": round(t_cpp / t_jax, 1)}))

    # 4. SABR Hagan smile: 4096 strikes
    from pde_tpu.models import sabr

    ns = 4096
    Ks = np.linspace(60.0, 140.0, ns)
    t_cpp = time_host(
        lambda: native.sabr_vols(0.25, 0.7, -0.3, 0.45, 100.0, 1.25, Ks), n=10
    )
    sp = sabr.SABRParams(alpha=0.25, beta=0.7, rho=-0.3, nu=0.45)
    Ksj = jnp.asarray(Ks, jnp.float32)
    jvols = jax.jit(lambda K: sabr.implied_volatilities(K, 100.0, 1.25, sp))
    t_jax = time_device(lambda: jvols(Ksj), n=30)
    print(json.dumps({"metric": "sabr_vols_4096_native_vs_jax",
                      "native_s": round(t_cpp, 6), "jax_s": round(t_jax, 6),
                      "speedup": round(t_cpp / t_jax, 1)}))

    # 5. tick->bar aggregation (host-side workload: C++ is the right tool;
    # report it as such)
    n_ticks = 1_000_000
    times = np.sort(rng.uniform(0, 3600, n_ticks))
    prices = 100.0 + np.cumsum(rng.normal(0, 0.01, n_ticks))
    sizes = rng.integers(1, 500, n_ticks).astype(float)
    t_cpp = time_host(lambda: native.aggregate_bars(times, prices, sizes, 60.0), n=5)
    print(json.dumps({"metric": "bar_aggregation_1m_ticks_native",
                      "native_s": round(t_cpp, 6),
                      "ticks_per_sec": round(n_ticks / t_cpp)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
