"""Calibration robustness sweep: recovery across random true surfaces.

The headline benchmark (bench.py) calibrates ONE synthetic surface; this
script guards against over-tuning to it by drawing random Heston parameter
sets across the realistic range, generating a 108-quote surface for each,
and requiring the two-stage (coarse-DE -> full-grid LM) pipeline to recover
the parameters to sub-1e-4 relative RMSE.

Run on the GPU for timing, or JAX_PLATFORMS=cpu for a correctness-only
sweep:

    python scripts/robustness_check.py [n_cases]

Latest CPU sweep: 6/6 (float64, worst rel RMSE 1.7e-6); GPU: not measured.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main(n_cases: int = 6) -> int:
    import jax
    import jax.numpy as jnp

    from pde_tpu.calibrate import HestonCalibrator

    rng = np.random.default_rng(0)
    ok, worst, t_tot = 0, 0.0, 0.0
    for i in range(n_cases):
        true = dict(
            kappa=float(rng.uniform(0.8, 4.0)),
            theta=float(rng.uniform(0.02, 0.1)),
            sigma=float(rng.uniform(0.2, 0.7)),
            rho=float(rng.uniform(-0.85, -0.2)),
            v0=float(rng.uniform(0.02, 0.1)),
        )
        data = HestonCalibrator.generate_synthetic_data(
            strikes=np.linspace(85.0, 115.0, 12),
            maturities=np.linspace(0.25, 1.5, 9),
            **true,
        )
        cal = HestonCalibrator()
        cal.calibrate(data, S0=100.0, r=0.05, q=0.02)  # warm the jit cache
        jax.block_until_ready(jnp.zeros(1))
        t0 = time.perf_counter()
        res = cal.calibrate(data, S0=100.0, r=0.05, q=0.02)
        t = time.perf_counter() - t0
        t_tot += t
        rmse = res.fit_quality["relative_rmse"]
        worst = max(worst, rmse)
        recovered = rmse < 1e-4
        ok += recovered
        print(f"case {i}: rel_rmse={rmse:.2e} t={t * 1e3:.1f}ms "
              f"{'OK' if recovered else 'FAIL'} true={true}")

    print(f"\n{ok}/{n_cases} recovered, worst rel RMSE {worst:.2e}, "
          f"mean latency {t_tot / n_cases * 1e3:.1f} ms")
    return 0 if ok == n_cases else 1


def main_pde(n_cases: int = 4, interpret: bool = False) -> int:
    """Fused ADI kernel vs scan-path agreement across random models.

    Each case draws a Heston parameter set and a 64-option batch of mixed
    strikes/maturities/calls/puts (half flagged American) and requires
    solve_fused_batch to agree with solve_batch everywhere the price is
    economically meaningful (> 0.05).  ``--interpret`` runs the kernel in
    the Pallas interpreter on a smaller grid (a CPU check).

    GPU sweep: not measured.
    """
    from pde_tpu.solvers import heston_adi

    rng = np.random.default_rng(1)
    worst = 0.0
    for i in range(n_cases):
        kappa = float(rng.uniform(0.8, 4.0))
        theta = float(rng.uniform(0.02, 0.1))
        sigma = float(rng.uniform(0.2, 0.7))
        rho = float(rng.uniform(-0.85, -0.2))
        v0 = float(rng.uniform(0.02, 0.1))
        B = 64
        K = rng.uniform(80.0, 120.0, B)
        T = rng.uniform(0.2, 2.0, B)
        ic = (rng.uniform(size=B) > 0.5).astype(float)
        am = (np.arange(B) % 2).astype(float)
        kw = dict(n_spot=48, n_vol=24, n_time=24) if interpret else {}
        fb = heston_adi.solve_fused_batch(
            kappa, theta, sigma, rho, v0, 0.05, 0.02, T, K, ic, 100.0,
            american=am, interpret=interpret, **kw
        )
        sb = heston_adi.solve_batch(
            kappa, theta, sigma, rho, v0, 0.05, 0.02, T, K, ic > 0.5, 100.0,
            american=True, **kw
        )
        pf = np.asarray(fb.price)
        # scan path's static american=True applies to ALL rows; compare the
        # flagged half against it and the unflagged half against European
        se = heston_adi.solve_batch(
            kappa, theta, sigma, rho, v0, 0.05, 0.02, T, K, ic > 0.5, 100.0,
            american=False, **kw
        )
        ref = np.where(am > 0.5, np.asarray(sb.price), np.asarray(se.price))
        mask = ref > 0.05
        rel = np.max(np.abs(pf[mask] - ref[mask]) / ref[mask])
        worst = max(worst, rel)
        print(f"pde case {i}: worst rel diff {rel:.2e} "
              f"{'OK' if rel < 2e-3 else 'FAIL'}")
    print(f"\nworst rel diff across sweep: {worst:.2e}")
    return 0 if worst < 2e-3 else 1


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a not in ("--pde", "--interpret")]
    n = int(args[0]) if args else None
    if "--pde" in sys.argv[1:]:
        sys.exit(main_pde(n if n is not None else 4,
                          interpret="--interpret" in sys.argv[1:]))
    sys.exit(main(n if n is not None else 6))
