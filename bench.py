#!/usr/bin/env python
"""Headline benchmark: full Heston surface calibration wall-clock, plus
three flagship family rows.

The headline reproduces the reference's north-star config (BASELINE.json /
SURVEY.md section 6): calibrate (kappa, theta, sigma, rho, v0) to a
synthetic surface of 108 quotes (12 strikes x 9 maturities) with the
two-stage pipeline — differential evolution (maxiter=100, popsize=15) +
Levenberg-Marquardt — the exact configuration the reference runs through
scipy + a C++ per-option pricing loop with a <30 s design target for 50
options (docs/design-doc.md:493; calibration/heston_calibrator.py:416-477).
Here the whole two-stage pipeline is ONE jitted XLA program; a DE
generation prices the population x 108 quotes x 70 quadrature nodes (a
corrected Gauss-Legendre rule reproducing the reference's 1024-point grid
to ~1e-9) as a single fused tensor op.

bench.py also emits one row per flagship family — the fused-ADI Heston
book, the fused local-vol book, and the SABR smile fit — each vs the
MEASURED reference number (benchmarks/REFERENCE_MEASURED.json).  Output
protocol: one JSON object per line on stdout, diagnostics on stderr, and
the HEADLINE row is always the LAST line.  Every row names the device
(``platform``, ``device_kind``, ``device_count``).  Without a GPU the
script exits non-zero (``BENCH_SMOKE=1`` asks for a CPU smoke run
explicitly); a failed flagship row prints an ``error`` row and the script
exits non-zero after the headline.
"""

import json
import os
import sys
import time

import numpy as np

# BENCH_SMOKE=1 shrinks every section to trace-and-run-once scale so the
# test suite can drive this file end-to-end on CPU (same contract as
# bench_full.py): same call expressions, meaningless numbers.
SMOKE = bool(os.environ.get("BENCH_SMOKE"))


def _n(full, smoke):
    return smoke if SMOKE else full


def _load_reference_measured():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "REFERENCE_MEASURED.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _timeit(fn, n=10):
    """Median host time of ``n`` calls, each ending in block_until_ready,
    after one warm-up call (compilation is not timed)."""
    import jax

    if SMOKE:
        n = 1
    jax.block_until_ready(fn())
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        runs.append(time.perf_counter() - t0)
    return float(np.median(runs))


_DEVICE = {}
_FAILED = []


def _fail(metric, exc):
    _FAILED.append(metric)
    print(f"# {metric} failed: {exc!r}", file=sys.stderr)
    print(json.dumps({"metric": metric, "error": repr(exc)[:200],
                      **_DEVICE}))


def _emit(metric, value, unit, ref=None, **extra):
    row = {"metric": metric, "value": round(float(value), 6), "unit": unit}
    if ref is not None:
        row["baseline"] = "reference_measured"
        row["reference_measured"] = round(float(ref), 6)
        row["vs_baseline"] = round(
            ref / value if unit.endswith("_s") or unit == "s"
            else value / ref, 1)
    row.update(extra)
    row.update(_DEVICE)
    print(json.dumps(row))
    sys.stdout.flush()


def _flagship_rows(measured):
    """The three family rows beyond the headline.  Each section is the
    same call expression as its bench_full.py counterpart (same metric
    names, so snapshots and the driver record stay comparable)."""
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    micro = measured.get("micro", {})

    # -- fused-ADI Heston book: 512 options (mixed K/T/call-put) through
    # ONE fused march kernel, one program per option (bench_full.py 4c)
    try:
        from pde_tpu.solvers import heston_adi

        B = _n(512, 128)
        Kf = jnp.asarray(np.linspace(85.0, 115.0, B), f32)
        Tf = jnp.asarray(np.linspace(0.25, 1.5, B), f32)
        cf = jnp.asarray((np.arange(B) % 2).astype(np.float32))
        fb_fn = lambda: heston_adi.solve_fused_batch(  # noqa: E731
            2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, Tf, Kf, cf, 100.0,
            n_time=_n(100, 4), interpret=SMOKE,
        ).price
        per = _timeit(fb_fn, n=10)
        ref = None
        if "heston_pde_solve_ms" in micro:
            ref = 1000.0 / micro["heston_pde_solve_ms"]  # serial C++ loop
        _emit("heston_adi_fused_batch512_options_per_sec", B / per,
              "options/s", ref)
    except Exception as e:  # noqa: BLE001 - reported, exit non-zero
        _fail("heston_adi_fused_batch512_options_per_sec", e)

    # -- fused local-vol book: 256 options on one Dupire surface, lattice
    # built as one-hot matrix products + fused march (bench_full.py 1g3)
    try:
        from pde_tpu.models import heston, local_vol
        from pde_tpu.solvers import local_vol_pde

        params = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
        ks_lv = jnp.asarray(np.exp(np.linspace(np.log(60.0), np.log(170.0),
                                               _n(24, 4))))
        ts_lv = jnp.asarray(np.linspace(0.05, 1.0, _n(6, 2)))
        surf_lv = jax.jit(lambda: local_vol.dupire_surface(
            params, ks_lv, ts_lv, 100.0, 0.04, 0.01))()
        interp_lv = local_vol.SurfaceInterpolator(ks_lv, ts_lv, surf_lv)
        B_lv = _n(256, 8)
        K_lvb = jnp.asarray(np.linspace(70.0, 140.0, B_lv), f32)
        T_lvb = jnp.asarray(np.linspace(0.25, 1.5, B_lv), f32)
        c_lvb = jnp.asarray((np.arange(B_lv) % 2).astype(np.float32))
        lv_book_fn = lambda: local_vol_pde.solve_fused_batch(  # noqa: E731
            interp_lv, 100.0, K=K_lvb, T=T_lvb, is_call=c_lvb, r=0.04,
            q=0.01, n_space=_n(200, 16), n_time=_n(100, 4),
            interpret=SMOKE).price
        per = _timeit(lv_book_fn, n=10)
        ref = None
        if "bs_pde_solve_ms" in micro:
            ref = 1000.0 / micro["bs_pde_solve_ms"]  # serial C++ CN loop
        _emit("local_vol_pde_fused_book256_options_per_sec", B_lv / per,
              "options/s", ref)
    except Exception as e:  # noqa: BLE001 - reported, exit non-zero
        _fail("local_vol_pde_fused_book256_options_per_sec", e)

    # -- SABR smile fit: jitted bounded-LM over (alpha, rho, nu), 11
    # strikes (bench_full.py 2b; reference: scipy SLSQP over compiled C++
    # Hagan, measured by benchmarks/run_reference_bench.py)
    try:
        from pde_tpu.calibrate.sabr import SABRCalibrator
        from pde_tpu.models import sabr

        scal = SABRCalibrator(beta=0.5)
        struth = sabr.SABRParams(0.25, 0.5, -0.35, 0.45)
        sk = np.linspace(80.0, 120.0, 11)
        F_1 = 100.0 * float(np.exp(0.03 * 1.0))
        smile_vols = np.asarray(jax.jit(
            lambda: sabr.implied_volatilities(jnp.asarray(sk, f32), F_1,
                                              1.0, struth))())
        per = _timeit(lambda: scal.calibrate_single_maturity(
            sk, smile_vols, F_1, 1.0), n=_n(20, 1))
        _, rmse_fit = scal.calibrate_single_maturity(sk, smile_vols, F_1, 1.0)
        ref = measured.get("sabr_calibration", {}).get("smile_fit_ms")
        _emit("sabr_smile_calibration_s", per, "fit_s",
              ref / 1000.0 if ref else None, rmse=round(float(rmse_fit), 8))
    except Exception as e:  # noqa: BLE001 - reported, exit non-zero
        _fail("sabr_smile_calibration_s", e)


def main():
    import jax

    from pde_tpu.utils.compile_cache import enable_compile_cache
    from pde_tpu.utils.profiling import device_info

    if SMOKE:
        jax.config.update("jax_platforms", "cpu")
    else:
        enable_compile_cache()
    _DEVICE.update(device_info(require=None if SMOKE else "gpu"))

    import jax.numpy as jnp

    from pde_tpu.calibrate.heston import HestonCalibrator, _calibrate_pipeline
    from pde_tpu.models.heston import group_maturities

    S0, r, q = 100.0, 0.05, 0.02
    TRUE = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)

    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=r, q=q, **TRUE,
        strikes=np.linspace(85.0, 115.0, 12),
        maturities=np.linspace(0.25, 1.5, 9),
    )
    n_quotes = len(data["strike"])

    g_maxiter, g_popsize, l_maxiter = _n(100, 3), _n(15, 4), _n(60, 3)
    cal = HestonCalibrator(global_maxiter=g_maxiter, global_popsize=g_popsize,
                           seed=42)
    lower = jnp.array([cal.bounds[k][0] for k in ("kappa", "theta", "sigma", "rho", "v0")])
    upper = jnp.array([cal.bounds[k][1] for k in ("kappa", "theta", "sigma", "rho", "v0")])

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    unique_T, t_idx = group_maturities(data["maturity"])
    args = (
        jnp.asarray(data["strike"], dtype=dtype),
        jnp.asarray(t_idx),
        jnp.asarray(unique_T, dtype=dtype),
        jnp.asarray(data["is_call"]),
        jnp.asarray(data["mid_price"], dtype=dtype),
        jnp.ones(len(data["strike"]), dtype=dtype),
        S0,
        r,
        q,
        lower.astype(dtype),
        upper.astype(dtype),
        jax.random.PRNGKey(42),
        jnp.zeros(5, dtype=dtype),
        jnp.asarray(False),
    )
    kwargs = dict(global_maxiter=g_maxiter, global_popsize=g_popsize,
                  local_max_iter=l_maxiter)

    wall = _timeit(lambda: _calibrate_pipeline(*args, **kwargs), n=_n(10, 1))
    out = _calibrate_pipeline(*args, **kwargs)

    # sanity: parameters recovered
    lm_x = np.asarray(out[3])
    rmse_rel = float(np.sqrt(2.0 * float(out[4]) / n_quotes))
    ok = abs(lm_x[4] - TRUE["v0"]) < 0.02 and rmse_rel < 0.05
    print(
        f"# device={_DEVICE} "
        f"n_quotes={n_quotes} "
        f"params={np.round(lm_x, 4).tolist()} rel_rmse={rmse_rel:.2e} ok={ok}",
        file=sys.stderr,
    )

    # baseline: the MEASURED reference two-stage calibration on the same
    # 108-quote surface (scipy DE + least_squares over the compiled
    # reference C++ pricer; benchmarks/run_reference_bench.py regenerates
    # benchmarks/REFERENCE_MEASURED.json).  Falls back to the published
    # <30 s design target if no measurement snapshot exists.
    measured = _load_reference_measured()
    baseline_s, baseline_src = 30.0, "published_target_30s"
    if "calibration_108" in measured:
        baseline_s = float(measured["calibration_108"]["wall_s"])
        baseline_src = "reference_measured"

    _flagship_rows(measured)

    # the HEADLINE row — ALWAYS the last stdout line
    print(
        json.dumps(
            {
                "metric": "heston_surface_calibration_wall_s",
                "value": round(wall, 4),
                "unit": "s",
                "vs_baseline": round(baseline_s / wall, 1),
                "baseline": baseline_src,
                "reference_measured_s": round(baseline_s, 3)
                if baseline_src == "reference_measured" else None,
                **_DEVICE,
            }
        )
    )
    if _FAILED:
        sys.exit(f"bench rows failed: {', '.join(_FAILED)}")


if __name__ == "__main__":
    main()
