#!/usr/bin/env python
"""Extended benchmark suite (the headline driver metric lives in bench.py).

Covers every BASELINE.json config on the attached device and prints one JSON
line per metric:

1. Carr-Madan pricing throughput (the reference's 10k options/sec config)
2. SABR smile evaluation throughput (~10 us/calc reference)
3. OU simulation + MLE (252 steps/obs, ~0.1 ms reference)
4. 2D Heston ADI PDE steps/sec (single and vmapped)
5. American Heston LCP solve
6. Full surface calibration (same as bench.py)
7. Batched multi-surface calibration throughput
"""

import json
import os
import sys
import time

import numpy as np

# BENCH_SMOKE=1 shrinks every section to trace-and-run-once scale so the
# test suite can drive the whole file end-to-end on CPU: each section calls
# the same library entry points with the same call expressions, so a
# signature change that would crash the real bench crashes the smoke test
# first.  Numbers printed under smoke are meaningless on purpose.
SMOKE = bool(os.environ.get("BENCH_SMOKE"))


def _n(full, smoke):
    return smoke if SMOKE else full


def _load_measured_baselines():
    """Measured reference numbers (benchmarks/run_reference_bench.py) keyed
    by OUR metric names.  Preferred over published design targets."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "REFERENCE_MEASURED.json")
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return {}
    micro = m.get("micro", {})
    out = {}
    if "heston_vec512_options_per_sec" in micro:
        out["heston_pricing_options_per_sec"] = micro["heston_vec512_options_per_sec"]
    if "sabr_vols_per_sec" in micro:
        out["sabr_vols_per_sec"] = micro["sabr_vols_per_sec"]
    if "ou_simulate252_ms" in micro:
        out["ou_sim252_paths_per_sec"] = 1000.0 / micro["ou_simulate252_ms"]
    if "ou_fit252_ms" in micro:
        out["ou_mle252_fits_per_sec"] = 1000.0 / micro["ou_fit252_ms"]
    if "heston_pde_solve_ms" in micro:
        # the reference prices PDE books by looping one solve per option
        pde_s = micro["heston_pde_solve_ms"] / 1000.0
        out["heston_adi_100x50_steps_per_sec"] = 100.0 / pde_s
        out["heston_adi_vmapped16_steps_per_sec"] = 100.0 / pde_s
        out["heston_adi_fused_solve_s"] = pde_s
        out["heston_adi_batch108_options_per_sec"] = 1.0 / pde_s
        out["heston_adi_mixed_book_options_per_sec"] = 1.0 / pde_s
        out["heston_adi_fused_batch512_options_per_sec"] = 1.0 / pde_s
    if "heston_pde_amer_solve_ms" in micro:
        out["heston_american_lcp_solve_s"] = micro["heston_pde_amer_solve_ms"] / 1000.0
        out["heston_american_lcp_fused_solve_s"] = (
            micro["heston_pde_amer_solve_ms"] / 1000.0)
        # same contract priced by LSM MC (the reference's only American
        # pricer is the PDE projection)
        out["heston_american_lsm_solve_s"] = (
            micro["heston_pde_amer_solve_ms"] / 1000.0)
    if "hjb_all_boundaries_ms" in micro:
        out["ou_freeboundary_psor_solve_s"] = micro["hjb_all_boundaries_ms"] / 1000.0
    if "bs_pde_solve_ms" in micro:
        # the reference prices BS-PDE books by looping one solve per option;
        # measured solve is its EUROPEAN default (200x100 CN) — slightly
        # favorable to the reference, since American adds a projection pass
        out["bs_american_book512_options_per_sec"] = (
            1000.0 / micro["bs_pde_solve_ms"])
        # local-vol march baselines: the reference's measured CONSTANT-
        # coefficient CN solve on the same 200x100 grid — a lower bound for
        # its generalized time-dependent march (black_scholes_pde.hpp:
        # 234-274 rebuilds the operator per step), i.e. favorable to it
        out["local_vol_pde_fused_solve_s"] = micro["bs_pde_solve_ms"] / 1000.0
        out["local_vol_pde_fused_book256_options_per_sec"] = (
            1000.0 / micro["bs_pde_solve_ms"])
    if "sabr_calibration" in m:
        sab = m["sabr_calibration"]
        out["sabr_smile_calibration_s"] = sab["smile_fit_ms"] / 1000.0
        out["sabr_surface_calibration_s"] = sab["surface_fit_s"]
        # the reference fits smiles serially
        out["sabr_batched_calibration_smiles_per_sec"] = (
            1000.0 / sab["smile_fit_ms"])
    if "calibration_108" in m:
        out["heston_surface_calibration_wall_s"] = m["calibration_108"]["wall_s"]
        # the reference calibrates surfaces serially
        out["heston_batched_calibration_surfaces_per_sec"] = (
            1.0 / m["calibration_108"]["wall_s"]
        )
    return out


_MEASURED = _load_measured_baselines()


class TimedValue(float):
    """The median of the timed runs, carrying every run's sample so emit()
    can attach median/min/max spread fields.  Dividing a scalar by a
    TimedValue (the universal per-rep-time -> throughput transform in this
    file) propagates the samples through the same transform, so the spread
    is always reported in the metric's own units."""

    def __new__(cls, value, samples):
        obj = super().__new__(cls, value)
        obj.samples = [float(s) for s in samples]
        return obj

    def __rtruediv__(self, other):
        return TimedValue(float(other) / float(self),
                          [float(other) / s for s in self.samples])


_DEVICE = {}


def emit(metric, value, unit, baseline=None):
    row = {"metric": metric, "value": round(float(value), 6), "unit": unit}
    if isinstance(value, TimedValue) and len(value.samples) > 1:
        ss = sorted(value.samples)
        row["value_median"] = round(float(np.median(ss)), 6)
        row["value_min"] = round(ss[0], 6)
        row["value_max"] = round(ss[-1], 6)
        row["n_trials"] = len(ss)
    if metric in _MEASURED:
        baseline = _MEASURED[metric]
        row["baseline"] = "reference_measured"
        row["reference_measured"] = round(baseline, 6)
    elif baseline:
        row["baseline"] = "published_target"
    if baseline:
        row["vs_baseline"] = round(baseline / value if unit.endswith("_s") else value / baseline, 1)
    row.update(_DEVICE)
    print(json.dumps(row))


def sync(x):
    import jax

    jax.block_until_ready(x)
    return x


def timeit(fn, n=20):
    """Median host time of ``n`` calls, each ending in block_until_ready,
    after one warm-up call (compilation is not timed)."""
    if SMOKE:
        n = 1
    sync(fn())
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        sync(fn())
        runs.append(time.perf_counter() - t0)
    return TimedValue(float(np.median(runs)), runs)


def main():
    import jax

    from pde_tpu.utils.compile_cache import enable_compile_cache
    from pde_tpu.utils.profiling import device_info

    if SMOKE:
        # smoke exists to catch bench/library signature drift in CI, which
        # runs on CPU; Pallas sections run in interpret mode below
        jax.config.update("jax_platforms", "cpu")
    else:
        enable_compile_cache()
    _DEVICE.update(device_info(require=None if SMOKE else "gpu"))
    import jax.numpy as jnp

    print(f"# device={_DEVICE}", file=sys.stderr)
    f32 = jnp.float32

    # 1. Heston pricing throughput ------------------------------------------
    from pde_tpu.models import heston

    params = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    n_opts = _n(8192, 64)
    strikes = jnp.asarray(np.linspace(60, 140, n_opts), f32)
    mats = jnp.asarray(np.tile(np.linspace(0.1, 2.0, 8), n_opts // 8), f32)
    price_fn = jax.jit(lambda: heston.price_carr_madan(params, strikes, mats, 100.0, 0.05, 0.02))
    per = timeit(price_fn, n=200)
    emit("heston_pricing_options_per_sec", n_opts / per, "options/s", baseline=10_000)

    # 1b. grouped-CF surface pricing: CF shared across strikes per unique
    # maturity (8 maturities here), the calibration hot-loop pricer
    uTb, idxb = heston.group_maturities(np.asarray(mats))
    idxb_j, uTb_j = jnp.asarray(idxb), jnp.asarray(uTb, f32)
    gp_fn = jax.jit(lambda: heston.price_carr_madan_grouped(
        params, strikes, idxb_j, uTb_j, 100.0, 0.05, 0.02))
    per = timeit(gp_fn, n=200)
    emit("heston_pricing_grouped_options_per_sec", n_opts / per, "options/s")

    # 1c. rough Heston smile: fractional-Riccati CF (implicit
    # product-trapezoidal scan) + converged-GL Carr-Madan.  No reference
    # counterpart — the model family itself is beyond the reference.
    from pde_tpu.models.rough_heston import RoughHestonParams, price_rough

    rpar = RoughHestonParams(0.1, 2.0, 0.04, 0.3, -0.7, 0.04)
    ks_r = jnp.asarray(np.linspace(80.0, 120.0, 64))
    rough_fn = jax.jit(lambda: price_rough(
        rpar, ks_r, 0.25, 100.0, 0.05, 0.02, n_steps=_n(192, 16)))
    per = timeit(rough_fn, n=20)
    emit("rough_heston_smile64_price_s", per, "smile_s")

    # 1d. rough Heston 6-parameter surface calibration (LM + jacfwd through
    # the fractional-Riccati scan) — 3 maturities x 9 strikes
    from pde_tpu.calibrate.rough import RoughHestonCalibrator

    rdata = RoughHestonCalibrator.generate_synthetic_surface(
        n_steps=_n(96, 8))
    rcal = RoughHestonCalibrator(n_steps=_n(96, 8), max_iter=_n(40, 2))
    t0 = time.perf_counter()
    rres = rcal.calibrate(rdata["strikes"], rdata["maturities"],
                          rdata["mid_prices"], rdata["S0"], rdata["r"],
                          rdata["q"])  # warm: compile
    rcal_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_reps = _n(3, 1)
    for _ in range(n_reps):
        rres = rcal.calibrate(rdata["strikes"], rdata["maturities"],
                              rdata["mid_prices"], rdata["S0"], rdata["r"],
                              rdata["q"])
    per = (time.perf_counter() - t0) / n_reps
    if not SMOKE:
        # f32 relative-residual floor on the chip; f64 CPU fits reach 1e-8+
        assert rres.rmse < 5e-3, rres
    emit("rough_heston_surface_calibration_s", per, "s")
    print(f"# rough calibration: compile {rcal_compile_s:.1f}s "
          f"rmse={rres.rmse:.1e} iters={rres.n_iter}", file=sys.stderr)

    # 1e. Bates smile through the affine-extension hook: the compensated
    # jump factor multiplies into the CF, so this is the SAME grouped-GL
    # program as classic Heston plus a few flops per node.  No reference
    # counterpart — model family beyond the reference.
    from pde_tpu.models.bates import BatesParams

    bpar = BatesParams(2.0, 0.04, 0.3, -0.7, 0.04, 0.6, -0.08, 0.18)
    bates_fn = jax.jit(lambda: heston.price_carr_madan_gl_grouped(
        bpar, strikes, idxb_j, uTb_j, 100.0, 0.05, 0.02))
    per = timeit(bates_fn, n=200)
    emit("bates_pricing_grouped_options_per_sec", n_opts / per, "options/s")

    # 1e2. digital book: grouped Gil-Pelaez cash digitals on the same flat
    # chain — two CF contours (u and u-i) per maturity shared across
    # strikes.  No reference counterpart (no digital pricer there).
    from pde_tpu.models import digital

    dig_fn = jax.jit(lambda: digital.price_grouped(
        params, strikes, idxb_j, uTb_j, 100.0, 0.05, 0.02))
    per = timeit(dig_fn, n=200)
    emit("digital_pricing_grouped_options_per_sec", n_opts / per, "options/s")

    # 1f. volatility derivatives: VIX-style strip on a dense OTM chain and
    # the exact vol-swap strike (Laplace-transform Gauss-Legendre)
    from pde_tpu.models import varswap

    n_k = _n(1024, 64)
    fwd = 100.0 * float(np.exp(0.02 * 0.5))
    ks_v = jnp.asarray(np.linspace(0.3 * fwd, 3.0 * fwd, n_k), f32)
    q_v = jax.jit(lambda: heston.price_carr_madan(
        params, ks_v, 0.5, 100.0, 0.03, 0.01, is_call=ks_v > fwd))()
    strip_fn = jax.jit(lambda: varswap.strip_variance(
        ks_v, q_v, fwd, 0.5, 0.03))
    per = timeit(strip_fn, n=400)
    emit("varswap_strip_evals_per_sec", 1.0 / per, "strips/s")
    volswap_fn = jax.jit(lambda: varswap.fair_volatility_strike(bpar, 0.5))
    per = timeit(volswap_fn, n=200)
    emit("volswap_exact_strike_s", per, "s")

    # 1h. multi-asset: conditioning-quadrature spread book (128 GL nodes
    # per quote), Stulz rainbow book (2 bivariate CDFs per quote), and
    # arithmetic-basket MC with the moment-matched geometric + level
    # two-control regression (exact terminal sampling: one matmul per
    # batch, no time stepping).  No reference counterpart (single-asset
    # stack throughout).
    from pde_tpu.models import multi_asset

    n_sp = _n(4096, 64)
    ks_sp = jnp.asarray(np.linspace(-15.0, 25.0, n_sp), f32)
    rho_sp = jnp.asarray(np.tile(np.linspace(-0.5, 0.9, 8), n_sp // 8), f32)
    spread_fn = jax.jit(lambda: jax.vmap(
        lambda k, r: multi_asset.spread_price_quad(
            100.0, 96.0, k, 0.9, 0.25, 0.35, r, rate=0.03,
            div1=0.01, div2=0.02)
    )(ks_sp, rho_sp))
    per = timeit(spread_fn, n=100)
    emit("spread_quad_prices_per_sec", n_sp / per, "options/s")

    rain_fn = jax.jit(lambda: jax.vmap(
        lambda k, r: multi_asset.rainbow_two_asset_price(
            100.0, 96.0, k, 0.9, 0.25, 0.35, r, rate=0.03,
            div1=0.01, div2=0.02, kind="call_on_min")
    )(jnp.abs(ks_sp) + 80.0, rho_sp))
    per = timeit(rain_fn, n=100)
    emit("rainbow_stulz_prices_per_sec", n_sp / per, "options/s")

    n_ba = _n(1 << 20, 1 << 10)
    spots_ba = jnp.asarray(np.linspace(90.0, 115.0, 8), f32)
    w_ba = jnp.full((8,), 0.125, f32)
    vols_ba = jnp.asarray(np.linspace(0.18, 0.42, 8), f32)
    corr_ba = jnp.asarray(
        0.45 * np.ones((8, 8)) + 0.55 * np.eye(8), f32)
    ks_ba = jnp.asarray(np.linspace(85.0, 120.0, 16), f32)
    key_ba = jax.random.PRNGKey(42)
    basket_fn = jax.jit(lambda: multi_asset.price_basket_mc(
        key_ba, spots_ba, w_ba, ks_ba, 0.9, vols_ba, corr_ba,
        rate=0.03, n_paths=n_ba)[0])
    per = timeit(basket_fn, n=20)
    emit("basket_mc_cv_paths_per_sec", n_ba / per, "paths/s")

    # 1g. Dupire local vol: AD surface extraction (3 derivatives of the
    # converged-GL pricer per node) + the local-vol CN PDE march
    from pde_tpu.models import local_vol

    n_lk, n_lt = _n(24, 4), _n(6, 2)
    ks_lv = jnp.asarray(np.exp(np.linspace(np.log(60.0), np.log(170.0), n_lk)))
    ts_lv = jnp.asarray(np.linspace(0.05, 1.0, n_lt))
    dup_fn = jax.jit(lambda: local_vol.dupire_surface(
        params, ks_lv, ts_lv, 100.0, 0.04, 0.01))
    per = timeit(dup_fn, n=20)
    emit("dupire_surface_nodes_per_sec", (n_lk * n_lt) / per, "nodes/s")
    surf_lv = dup_fn()
    interp_lv = local_vol.SurfaceInterpolator(ks_lv, ts_lv, surf_lv)
    from pde_tpu.solvers import local_vol_pde

    lv_ns, lv_nt = _n(200, 16), _n(100, 4)
    lv_fn = jax.jit(lambda: local_vol_pde.solve(
        interp_lv, 100.0, K=100.0, T=1.0, r=0.04, q=0.01, is_call=True,
        n_space=lv_ns, n_time=lv_nt).price)
    per = timeit(lv_fn, n=50)
    emit("local_vol_pde_solve_s", per, "solve_s")

    # 1g2. the fused local-vol march (ops/cn1d_tv_fused): sigma(s,t) lattice
    # and all per-step diagonals precomputed in one tensor op, whole march
    # in one Pallas kernel with per-step coefficient rows streamed from HBM
    lv_fused_fn = lambda: local_vol_pde.solve_fused(
        interp_lv, 100.0, K=100.0, T=1.0, r=0.04, q=0.01, is_call=True,
        n_space=lv_ns, n_time=lv_nt, interpret=SMOKE).price
    per = timeit(lv_fused_fn, n=50)
    emit("local_vol_pde_fused_solve_s", per, "solve_s")

    # 1g3. a whole mixed book on ONE Dupire surface through the fused march
    # (strikes x maturities, calls and puts, in one kernel call); the
    # reference would loop its generalized C++ march once per contract
    B_lv = _n(256, 8)
    K_lvb = jnp.asarray(np.linspace(70.0, 140.0, B_lv), f32)
    T_lvb = jnp.asarray(np.linspace(0.25, 1.5, B_lv), f32)
    c_lvb = jnp.asarray((np.arange(B_lv) % 2).astype(np.float32))
    lv_book_fn = lambda: local_vol_pde.solve_fused_batch(
        interp_lv, 100.0, K=K_lvb, T=T_lvb, is_call=c_lvb, r=0.04, q=0.01,
        n_space=lv_ns, n_time=lv_nt, interpret=SMOKE).price
    per = timeit(lv_book_fn, n=10)
    emit("local_vol_pde_fused_book256_options_per_sec", B_lv / per,
         "options/s")

    # 1h. SLV particle calibration: leveraged-QE step + binned E[v|S] per
    # step, one lax.scan end to end
    from pde_tpu.models import slv as slv_mod

    slv_paths, slv_steps = _n(65536, 512), _n(48, 4)
    slv_fn = jax.jit(lambda: slv_mod.calibrate_leverage(
        params, lambda s, t: jnp.full_like(s, 0.2), 100.0, 0.5,
        jax.random.PRNGKey(0), n_steps=slv_steps, n_paths=slv_paths,
        n_bins=31, rate=0.05)[0].values)
    per = timeit(slv_fn, n=20)
    emit("slv_calibration_particle_steps_per_sec",
         slv_paths * slv_steps / per, "particle-steps/s")

    # 1i. Hull-White rates desk: ATM swaption panel (Jamshidian strips,
    # fixed-trip Newton for r*) and the 2-parameter caplet-strip LM fit.
    # New family beyond the reference (equity-only models).
    from pde_tpu.calibrate.rates import HullWhiteCalibrator
    from pde_tpu.models import rates as rates_mod

    hw_curve = rates_mod.curve_from_zero_rates(
        jnp.asarray([0.5, 1.0, 2.0, 5.0, 10.0, 30.0], f32),
        jnp.asarray([0.030, 0.032, 0.035, 0.040, 0.042, 0.043], f32))
    hw = rates_mod.HullWhiteParams(
        jnp.asarray(0.1, f32), jnp.asarray(0.012, f32), hw_curve)
    n_sw = _n(256, 8)
    sw_expiries = jnp.asarray(np.linspace(0.5, 10.0, n_sw), f32)
    sw_pay_rel = jnp.asarray(np.arange(0.5, 5.01, 0.5), f32)  # 5y semi

    def _one_swaption(e):
        pay = e + sw_pay_rel
        par = rates_mod.hw_swap_rate(hw_curve, e, pay)
        return rates_mod.hw_swaption(hw, par, e, pay)

    swaption_fn = jax.jit(lambda: jax.vmap(_one_swaption)(sw_expiries))
    per = timeit(swaption_fn, n=50)
    emit("hw_swaption_panel_prices_per_sec", n_sw / per, "swaptions/s")

    hw_starts = jnp.asarray(np.arange(0.5, 8.01, 0.5), f32)
    hw_ends = hw_starts + 0.5
    hw_ks = hw_curve.forward(hw_starts, hw_ends)
    hw_quotes = rates_mod.hw_caplet(hw, hw_ks, hw_starts, hw_ends)
    hw_cal = HullWhiteCalibrator(max_iter=_n(60, 6))

    def hw_fit():
        return hw_cal.calibrate_caplets(
            hw_curve, hw_starts, hw_ends, hw_ks, hw_quotes).rmse

    per = timeit(hw_fit, n=5)
    emit("hw_caplet_calibration_wall_s", per, "fit_s")

    # 1j. Bermudan swaption desk: a strike LADDER through one x-grid CN
    # march each (vmap over strikes -> lanes), and the exact-transition
    # LSM + Andersen-Broadie sandwich for the ATM trade.
    from pde_tpu.solvers.bermudan_hw import (
        _bermudan_pde_impl, _march_plan, bermudan_swaption_mc,
    )

    bm_sched = jnp.asarray(np.arange(1.0, 6.01, 0.5), f32)
    bm_ex = (True,) * (bm_sched.shape[0] - 1)
    bm_par = float(rates_mod.hw_swap_rate(hw_curve, 1.0, bm_sched[1:]))
    bm_ks = jnp.asarray(np.linspace(0.6, 1.4, _n(64, 8)) * bm_par, f32)
    bm_plan = _march_plan(bm_sched, bm_ex, 16, f32)

    def _bm_one(k):
        return _bermudan_pde_impl(
            hw, k, bm_sched, *bm_plan[:4],
            payer=True, n_x=257, last=bm_plan[4], exercise=bm_ex)[0]

    bm_fn = jax.jit(lambda: jax.vmap(_bm_one)(bm_ks))
    per = timeit(bm_fn, n=20)
    emit("hw_bermudan_pde_ladder_prices_per_sec", bm_ks.shape[0] / per,
         "bermudans/s")

    bm_mc = jax.jit(lambda: bermudan_swaption_mc(
        hw, bm_par, bm_sched, jax.random.PRNGKey(7),
        n_paths=_n(1 << 15, 1 << 10), n_outer=_n(512, 64),
        n_inner=_n(32, 8)))
    per = timeit(bm_mc, n=3)
    lo_b, _, up_b, _ = (float(v) for v in bm_mc())
    emit("hw_bermudan_mc_sandwich_wall_s", per, "solve_s")
    emit("hw_bermudan_duality_gap_pct",
         100.0 * (up_b - lo_b) / max(lo_b, 1e-12), "pct")

    # 1k. G2++ two-factor desk: Gauss-Hermite swaption panel (the B-M 1D
    # reduction, node-vectorized Newton inside) and the 5-parameter LM fit.
    from pde_tpu.calibrate.g2 import G2Calibrator
    from pde_tpu.models import g2 as g2_mod

    g2p = g2_mod.G2Params(
        jnp.asarray(0.5, f32), jnp.asarray(0.05, f32),
        jnp.asarray(0.01, f32), jnp.asarray(0.008, f32),
        jnp.asarray(-0.6, f32), hw_curve)
    n_g2 = _n(128, 4)
    g2_exp = jnp.asarray(np.linspace(0.5, 10.0, n_g2), f32)

    def _one_g2(e):
        pt = e + sw_pay_rel
        par = rates_mod.hw_swap_rate(hw_curve, e, pt)
        return g2_mod.g2_swaption(g2p, par, e, pt, n_gh=64)

    g2_fn = jax.jit(lambda: jax.vmap(_one_g2)(g2_exp))
    per = timeit(g2_fn, n=20)
    emit("g2_swaption_panel_prices_per_sec", n_g2 / per, "swaptions/s")

    g2_exps = [1.0, 2.0, 3.0, 5.0]
    g2_pts = [jnp.asarray(np.arange(e + 0.5, e + 3.01, 0.5), f32)
              for e in g2_exps]
    g2_ks = [float(rates_mod.hw_swap_rate(hw_curve, e, pt))
             for e, pt in zip(g2_exps, g2_pts)]
    g2_quotes = jnp.asarray([
        float(g2_mod.g2_swaption(g2p, k, e, pt))
        for e, pt, k in zip(g2_exps, g2_pts, g2_ks)], f32)
    g2_cal = G2Calibrator(max_iter=_n(60, 4))

    def g2_fit():
        return g2_cal.calibrate_swaptions(
            hw_curve, g2_exps, g2_pts, g2_ks, g2_quotes).rmse

    per = timeit(g2_fit, n=3)
    emit("g2_swaption_calibration_wall_s", per, "fit_s")

    # 1l. credit desk: CDS hazard bootstrap (pricer-consistent Newton) and
    # the netting-set CVA engine (exact-transition HW exposure MC).
    from pde_tpu.models import credit as credit_mod

    cr_pillars = jnp.asarray([1.0, 3.0, 5.0, 7.0, 10.0], f32)
    cr_spreads = jnp.asarray([0.008, 0.011, 0.013, 0.014, 0.015], f32)

    def cr_boot():
        hc, hs = credit_mod.bootstrap_hazard(hw_curve, cr_pillars,
                                             cr_spreads)
        return float(hs[-1])

    per = timeit(cr_boot, n=3)
    emit("cds_bootstrap_5pillar_wall_s", per, "fit_s")

    cr_hz = credit_mod.flat_hazard(jnp.asarray(0.02, f32))
    cr_sched = jnp.asarray(np.arange(0.5, 5.01, 0.5), f32)
    cr_k = float(rates_mod.hw_swap_rate(hw_curve, 0.5, cr_sched[1:]))
    # uneven notionals so the float legs do NOT net to zero (equal
    # notionals with paired signs leave a deterministic residual and the
    # exposure would be identically 0)
    cr_trades = [
        credit_mod.SwapTrade(jnp.asarray(cr_k * m, f32),
                             jnp.asarray(sgn, f32), jnp.asarray(nt, f32))
        for m, sgn, nt in ((1.0, 1.0, 1.0), (0.9, -1.0, 0.4),
                           (1.1, 1.0, 0.7), (1.05, -1.0, 0.3))
    ]

    def cr_cva():
        cva, _, _ = credit_mod.cva_netting_hw_mc(
            hw, cr_hz, cr_trades, cr_sched, jax.random.PRNGKey(11),
            n_paths=_n(1 << 16, 1 << 10))
        return float(cva)

    per = timeit(cr_cva, n=5)
    emit("cva_netting4_wall_s", per, "solve_s")

    # 2. SABR throughput -----------------------------------------------------
    from pde_tpu.models import sabr

    sp = sabr.SABRParams(0.2, 0.5, -0.3, 0.4)
    n_v = _n(65536, 256)
    ks = jnp.asarray(np.linspace(60, 140, n_v), f32)
    sabr_fn = jax.jit(lambda: sabr.implied_volatilities(ks, 100.0, 1.0, sp))
    per = timeit(sabr_fn, n=400)
    emit("sabr_vols_per_sec", n_v / per, "vols/s", baseline=100_000)  # 10us/calc

    # 2b. SABR CALIBRATION (BASELINE config #2's fit stage; round-2 verdict
    # #4: the fit existed but carried no wall-clock row).  Jitted bounded-LM
    # over (alpha, rho, nu), raced against the reference's scipy SLSQP
    # driven through its own compiled C++ Hagan evaluator
    # (benchmarks/run_reference_bench.py measure_sabr_calibration; design
    # targets <1 s/smile, <10 s/surface at design-doc.md:695-696).
    from pde_tpu.calibrate.sabr import SABRCalibrator

    scal = SABRCalibrator(beta=0.5)
    struth = sabr.SABRParams(0.25, 0.5, -0.35, 0.45)
    n_sk = 11
    sk = np.linspace(80.0, 120.0, n_sk)
    F_1 = 100.0 * float(np.exp(0.03 * 1.0))
    smile_vols = np.asarray(jax.jit(
        lambda: sabr.implied_volatilities(jnp.asarray(sk, f32), F_1, 1.0,
                                          struth))())
    scal.calibrate_single_maturity(sk, smile_vols, F_1, 1.0)  # warm: compile
    t0 = time.perf_counter()
    n_reps = _n(20, 1)
    for _ in range(n_reps):
        sp_fit, rmse_fit = scal.calibrate_single_maturity(
            sk, smile_vols, F_1, 1.0)
    per = (time.perf_counter() - t0) / n_reps
    if not SMOKE:
        assert rmse_fit < 1e-4, rmse_fit
    emit("sabr_smile_calibration_s", per, "fit_s")

    # 2c. 10-maturity surface through calibrate() (regular-surface fast
    # path: every smile in one vmapped jitted call + one device pull)
    n_smat = 10
    T_sab = np.linspace(0.1, 2.0, n_smat)
    F_sab = 100.0 * np.exp(0.03 * T_sab)
    surf_vols = np.asarray(jax.jit(lambda: jax.vmap(
        lambda F, T: sabr.implied_volatilities(jnp.asarray(sk, f32), F, T,
                                               struth)
    )(jnp.asarray(F_sab, f32), jnp.asarray(T_sab, f32)))())
    chain_sab = {
        "strike": np.tile(sk, n_smat),
        "T": np.repeat(T_sab, n_sk),
        "implied_vol": surf_vols.ravel(),
    }
    scal.calibrate(chain_sab, F0=100.0, r=0.03, q=0.0)  # warm: compile
    t0 = time.perf_counter()
    for _ in range(n_reps):
        sres = scal.calibrate(chain_sab, F0=100.0, r=0.03, q=0.0)
    per = (time.perf_counter() - t0) / n_reps
    if not SMOKE:
        assert max(sres.rmse_by_maturity.values()) < 1e-4
    emit("sabr_surface_calibration_s", per, "fit_s")

    # 2d. a BOOK of surfaces: M smiles in one vmapped fit (the batch axis
    # is the device design point; the reference fits smiles serially)
    M_sab = _n(64, 4)
    Tm = np.linspace(0.1, 2.0, M_sab)
    Fm = 100.0 * np.exp(0.03 * Tm)
    vols_m = np.asarray(jax.jit(lambda: jax.vmap(
        lambda F, T: sabr.implied_volatilities(jnp.asarray(sk, f32), F, T,
                                               struth)
    )(jnp.asarray(Fm, f32), jnp.asarray(Tm, f32)))())
    s_mat = np.tile(sk, (M_sab, 1))
    scal.calibrate_surface_batch(s_mat, vols_m, Fm, Tm)  # warm: compile
    t0 = time.perf_counter()
    for _ in range(n_reps):
        out_b = scal.calibrate_surface_batch(s_mat, vols_m, Fm, Tm)
    per = (time.perf_counter() - t0) / n_reps
    if not SMOKE:
        assert float(np.max(np.asarray(out_b["rmse"]))) < 1e-4
    emit("sabr_batched_calibration_smiles_per_sec", M_sab / per, "smiles/s")

    # 3. OU simulate + fit ---------------------------------------------------
    from pde_tpu.models import ou

    op = ou.OUParams(100.0, 5.0, 2.0)
    n_paths = _n(1024, 8)
    keys = jax.random.split(jax.random.PRNGKey(0), n_paths)
    sim_fn = jax.jit(lambda: jax.vmap(lambda k: ou.simulate(op, 100.0, 1.0, 252, k))(keys))
    per = timeit(sim_fn, n=100)
    emit("ou_sim252_paths_per_sec", n_paths / per, "paths/s", baseline=10_000)  # 0.1ms/path

    paths = sim_fn()
    fit_fn = jax.jit(lambda: jax.vmap(lambda x: ou.fit_mle(x, 1 / 252).params.mu)(paths))
    per = timeit(fit_fn, n=100)
    emit("ou_mle252_fits_per_sec", n_paths / per, "fits/s", baseline=10_000)

    # 3a. parallel-in-time long path: 1M-step single path via
    # associative_scan (log-depth) — the sequential scan (and the
    # reference's serial loop, ou_process.cpp:230-256) is latency-bound at
    # ~n dependent steps
    n_long = _n(1_000_000, 4096)
    long_fn = jax.jit(
        lambda k: ou.simulate_parallel(op, 100.0, 4.0, n_long, k)[-1]
    )
    k0 = jax.random.PRNGKey(7)
    long_fn(k0)  # compile
    per = timeit(lambda: long_fn(k0), n=5)
    emit("ou_sim_longpath_steps_per_sec", n_long / per, "steps/s")

    # 3b. Heston Monte Carlo (Andersen QE) ------------------------------------
    # No reference baseline: the reference platform has no MC option pricer
    # (its only MC is the backtest bootstrap / VaR simulator).
    from pde_tpu.models import heston_mc

    n_mc = _n(1 << 17, 64)
    mc_steps = _n(64, 4)
    mc_key = jax.random.PRNGKey(0)
    mc_fn = jax.jit(
        lambda: heston_mc.simulate_qe(
            params, 100.0, 1.0, mc_key,
            n_steps=mc_steps, n_paths=n_mc, rate=0.05, dividend=0.02,
        ).spot
    )
    per = timeit(mc_fn, n=20)
    emit("heston_mc_qe_pathsteps_per_sec", n_mc * mc_steps / per, "path-steps/s")

    # 3c. American via Longstaff-Schwartz (same contract as the ADI LCP row)
    from pde_tpu.solvers.lsm import price_american_lsm

    lsm_fn = jax.jit(
        lambda: price_american_lsm(
            params, 100.0, 1.0, 100.0, mc_key, rate=0.05, is_call=False,
            n_steps=mc_steps, n_paths=_n(1 << 16, 64),
        )[0]
    )
    per = timeit(lsm_fn, n=10)
    emit("heston_american_lsm_solve_s", per, "solve_s")

    # 3d. a whole American book off ONE path set: per-strike regressions
    # vmapped over a shared simulation (the reference would loop its PDE
    # solver once per contract)
    from pde_tpu.solvers.lsm import price_american_lsm_batch

    B_lsm = _n(128, 4)
    strikes_lsm = jnp.linspace(70.0, 130.0, B_lsm)
    sides_lsm = jnp.arange(B_lsm) % 2 == 0
    lsm_book_fn = jax.jit(
        lambda: price_american_lsm_batch(
            params, strikes_lsm, sides_lsm, 1.0, 100.0, mc_key, rate=0.05,
            n_steps=mc_steps, n_paths=_n(1 << 16, 64),
        )[0]
    )
    per = timeit(lsm_book_fn, n=5)
    emit("heston_american_lsm_batch128_options_per_sec", B_lsm / per,
         "options/s")

    # 3d2. Andersen-Broadie dual bound: the price sandwich for the frozen
    # LSM policy (out-of-sample lower + martingale-duality upper).  Emits
    # the duality gap (policy-quality evidence no grid solver provides) and
    # the wall clock of the whole nested O(steps^2) estimator.
    from pde_tpu.solvers.lsm_dual import dual_upper_bound

    dual_fn = jax.jit(lambda: dual_upper_bound(
        params, 100.0, 1.0, 100.0, mc_key, rate=0.05, is_call=False,
        n_steps=_n(12, 4), n_reg_paths=_n(1 << 15, 1 << 10),
        n_outer=_n(1024, 64), n_inner=_n(64, 8)))
    per = timeit(dual_fn, n=3)
    lo_d, _, up_d, _ = (float(x) for x in dual_fn())
    emit("lsm_dual_sandwich_wall_s", per, "solve_s")
    emit("lsm_dual_gap_pct", 100.0 * (up_d - lo_d) / max(lo_d, 1e-12), "pct")

    # 3e. forward-start smile: analytic (chi-square-mixed forward CF) vs the
    # MC route it cross-validates; the reference has neither
    from pde_tpu.models import forward_start

    B_fs = _n(256, 8)
    k_fs = jnp.linspace(0.7, 1.3, B_fs)
    fs_fn = jax.jit(
        lambda: forward_start.price_forward_start(
            params, k_fs, 0.5, 1.0, rate=0.05, dividend=0.02
        )
    )
    per = timeit(fs_fn, n=20)
    emit("forward_start_analytic_smile256_options_per_sec", B_fs / per,
         "options/s")

    # 3f. pathwise AD greeks: 7 tangents through the whole QE scan in one pass
    greeks_fn = jax.jit(
        lambda: heston_mc.greeks_european_mc(
            params, jnp.linspace(80.0, 120.0, _n(16, 4)), 1.0, 100.0, mc_key,
            rate=0.05, dividend=0.02,
            n_steps=mc_steps, n_paths=_n(1 << 16, 64),
        )["delta"]
    )
    per = timeit(greeks_fn, n=5)
    emit("heston_mc_ad_greeks_16strike_s", per, "solve_s")

    # 3g. jump-diffusion PIDE: a whole strike strip through ONE IMEX march
    # with the jump convolution as a Toeplitz matmul (the reference has
    # no PIDE solver family at all; closest is its per-option local-operator
    # loop, black_scholes_pde.hpp:97-147)
    from pde_tpu.solvers.pide import KouJumps, MertonJumps, solve_pide

    B_pd = _n(128, 8)
    k_pd = jnp.linspace(70.0, 130.0, B_pd)
    mj_b = MertonJumps(0.5, -0.1, 0.15)
    nsp_pd, ntp_pd = _n(512, 64), _n(128, 16)
    per = timeit(
        lambda: solve_pide(mj_b, 0.2, 0.05, 0.02, 0.5, k_pd, 100.0,
                           n_space=nsp_pd, n_time=ntp_pd).price, n=20)
    emit("pide_merton_strip128_options_per_sec", B_pd / per, "options/s")

    kj_b = KouJumps(1.0, 0.4, 10.0, 5.0)
    per = timeit(
        lambda: solve_pide(kj_b, 0.2, 0.05, 0.02, 0.5, k_pd, 100.0,
                           is_call=False, american=True,
                           n_space=nsp_pd, n_time=ntp_pd).price, n=20)
    emit("pide_kou_american_strip128_options_per_sec", B_pd / per,
         "options/s")

    # 4. Heston ADI ----------------------------------------------------------
    from pde_tpu.solvers import heston_adi

    hp = heston_adi.HestonPDEParams(q=0.02, n_time=_n(100, 8))
    adi_fn = jax.jit(lambda: heston_adi.solve(hp, 100.0).price)
    per = timeit(adi_fn, n=30)
    emit("heston_adi_100x50_steps_per_sec", hp.n_time / per, "steps/s")

    n_sp = _n(16, 4)
    spots = jnp.asarray(np.linspace(80, 120, n_sp), f32)
    vm_fn = jax.jit(lambda: jax.vmap(lambda s: heston_adi.solve(hp, s).price)(spots))
    per = timeit(vm_fn, n=10)
    emit("heston_adi_vmapped16_steps_per_sec", n_sp * hp.n_time / per, "steps/s")

    # 4a. fully-fused Pallas march (whole time loop in one kernel) ------------
    fused_fn = jax.jit(lambda: heston_adi.solve_fused(hp, 100.0, interpret=SMOKE).price)
    per = timeit(fused_fn, n=100)
    emit("heston_adi_fused_solve_s", per, "solve_s")

    # 4b. whole-surface PDE pricing (solve_batch: traced strikes/maturities/
    # call-put flags, one compiled march) -------------------------------------
    nKb, nTb = _n(12, 4), _n(9, 2)
    Bq = nKb * nTb
    Kb = jnp.asarray(np.tile(np.linspace(85.0, 115.0, nKb), nTb), f32)
    Tb = jnp.asarray(np.repeat(np.linspace(0.25, 1.5, nTb), nKb), f32)
    cb = jnp.asarray(np.arange(Bq) % 2 == 0)
    batch_fn = jax.jit(
        lambda: heston_adi.solve_batch(
            2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, Tb, Kb, cb, 100.0,
            n_time=hp.n_time,
        ).price
    )
    per = timeit(batch_fn, n=10)
    emit("heston_adi_batch108_options_per_sec", Bq / per, "options/s")

    # 4b2. the SAME mixed 108-option surface through the fused march
    # kernel.  No bucketing needed — the kernel already traces per-option
    # strike/maturity/side (shared K-scaled log-moneyness grid, per-option
    # dt), one program per option.  Accuracy parity vs solve_batch:
    # tests/test_solvers.py.
    cfb = cb.astype(f32)
    mixed_fn = lambda: heston_adi.solve_fused_batch(
        2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, Tb, Kb, cfb, 100.0,
        n_time=hp.n_time, interpret=SMOKE,
    ).price
    per = timeit(mixed_fn, n=10)
    emit("heston_adi_mixed_book_options_per_sec", Bq / per, "options/s")

    # 4c. fused march: the whole desk inside ONE Pallas kernel, one
    # program per option ------------------------------------------------
    B = _n(512, 128)
    Kf = jnp.asarray(np.linspace(85.0, 115.0, B), f32)
    Tf = jnp.asarray(np.linspace(0.25, 1.5, B), f32)
    cf = jnp.asarray((np.arange(B) % 2).astype(np.float32))
    fb_fn = lambda: heston_adi.solve_fused_batch(
        2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, Tf, Kf, cf, 100.0,
        n_time=hp.n_time, interpret=SMOKE,
    ).price
    per = timeit(fb_fn, n=10)
    emit("heston_adi_fused_batch512_options_per_sec", B / per, "options/s")

    # 4d. Black-Scholes AMERICAN book through the fused 1D march: the
    # whole mixed book (vols x maturities x strikes, calls and puts) in ONE
    # Pallas kernel.  The reference prices such books one C++ solve at a time
    # (black_scholes_pde.hpp:97-147, bs_pde_solve_ms serial loop) -------------
    from pde_tpu.solvers import bs_pde

    B_bs = _n(512, 128)
    sig_b = jnp.asarray(np.linspace(0.15, 0.45, B_bs), f32)
    T_bs = jnp.asarray(np.linspace(0.25, 1.5, B_bs), f32)
    K_bs = jnp.asarray(np.linspace(80.0, 120.0, B_bs), f32)
    c_bs = jnp.asarray((np.arange(B_bs) % 2).astype(np.float32))
    bs_fn = lambda: bs_pde.solve_fused_batch(
        sig_b, 0.05, 0.01, T_bs, K_bs, c_bs, 100.0,
        american=jnp.ones(B_bs, f32), interpret=SMOKE,
    ).price
    per = timeit(bs_fn, n=10)
    emit("bs_american_book512_options_per_sec", B_bs / per, "options/s")

    # 5. American LCP --------------------------------------------------------
    am = hp._replace(is_call=False, american=True, american_method="it_lcp", r=0.08, q=0.0)
    am_fn = jax.jit(lambda: heston_adi.solve(am, 90.0).price)
    per = timeit(am_fn, n=30)
    emit("heston_american_lcp_solve_s", per, "solve_s")

    am_fused = jax.jit(lambda: heston_adi.solve_fused(am, 90.0, interpret=SMOKE).price)
    per = timeit(am_fused, n=100)
    emit("heston_american_lcp_fused_solve_s", per, "solve_s")

    # 5a-bis. American under SV + JUMPS: Bates 2D PIDE (Douglas ADI + CNAB
    # jump term as one (nS,nS)@(nS,nv) matmul per step).  The reference
    # has no PDE/PIDE route under jumps — no baseline exists to race.
    from pde_tpu.solvers.bates_pide import BatesPIDEParams, solve_bates_pide

    bpp = BatesPIDEParams(
        q=0.02, is_call=False, american=True, american_method="it_lcp",
        jumps=MertonJumps(0.5, -0.1, 0.15), n_time=_n(100, 10),
    )
    per = timeit(lambda: solve_bates_pide(bpp, 100.0).price, n=10)
    emit("bates_pide_american_solve_s", per, "solve_s")

    # 5b. OU free-boundary PSOR entry/exit with transaction costs
    # (Leung-Li; BASELINE.json config #3, reference design-doc.md:913
    # boundary-optimization target <5 s) --------------------------------------
    from pde_tpu.solvers import hjb

    # rigorous LCP via Brennan-Schwartz: the EXACT free-boundary solution in
    # one projected tridiagonal pass per step (validated == PSOR-200 to 1e-15,
    # tests/test_lcp.py), ~60x fewer serial ops than the PSOR iteration
    hjb_p = hjb.HJBParams(
        theta=0.0, mu=5.0, sigma=0.1, r=0.05, c_entry=0.002, c_exit=0.002,
        T=1.0, n_space=_n(256, 64), n_time=_n(128, 16),
        method="brennan_schwartz",
    )
    hjb.solve_all_boundaries(hjb_p)  # warm: compile
    t0 = time.perf_counter()
    n_reps = _n(5, 1)
    for _ in range(n_reps):
        bounds = hjb.solve_all_boundaries(hjb_p)
    per = (time.perf_counter() - t0) / n_reps
    assert bounds.entry_long < bounds.exit_long  # sane boundary ordering
    emit("ou_freeboundary_psor_solve_s", per, "solve_s", baseline=5.0)

    # the device design point: a BOOK of pair configs in one vmapped launch —
    # the serial time chain amortizes across the batch (the reference loops
    # its 2.6 ms solve per pair)
    B_hjb = _n(64, 4)
    per = timeit(
        jax.jit(lambda: hjb.boundaries_batch(
            theta=jnp.zeros(B_hjb), mu=jnp.linspace(2.0, 8.0, B_hjb),
            sigma=jnp.linspace(0.05, 0.2, B_hjb), r=0.05,
            c_entry=0.002, c_exit=0.002, T=1.0,
            n_space=_n(256, 64), n_time=_n(128, 16),
        )[1]),
        n=_n(5, 1),
    )
    emit("ou_freeboundary_batch64_books_per_sec", B_hjb / per, "books/s")

    # 6/7. calibration headline + batched ------------------------------------
    from pde_tpu.calibrate.heston import HestonCalibrator

    data = HestonCalibrator.generate_synthetic_data(
        S0=100.0, r=0.05, q=0.02,
        strikes=np.linspace(85.0, 115.0, 12), maturities=np.linspace(0.25, 1.5, 9),
    )
    cal = HestonCalibrator(global_maxiter=_n(100, 6), global_popsize=_n(15, 4))
    U = _n(16, 2)
    Ks = np.tile(np.asarray(data["strike"]), (U, 1))
    Ts = np.tile(np.asarray(data["maturity"]), (U, 1))
    Ps = np.tile(np.asarray(data["mid_price"]), (U, 1))
    spots_b = np.full(U, 100.0)

    out = cal.calibrate_batch(Ks, Ts, Ps, spots_b, 0.05, 0.02)
    sync(out["params"])
    t0 = time.perf_counter()
    out = cal.calibrate_batch(Ks, Ts, Ps, spots_b, 0.05, 0.02)
    sync(out["params"])
    per = time.perf_counter() - t0
    emit("heston_batched_calibration_surfaces_per_sec", U / per, "surfaces/s")

    # 7b. BASELINE config #5 tail: calibration -> vol-arb signal -> vol-managed
    # position sizing, end to end (reference critical-path target <5 s,
    # design-doc.md:357; position sizer risk/position_sizer.py:351) ----------
    from pde_tpu.models import black_scholes as bs_mod
    from pde_tpu.risk.position_sizer import VolatilityScaledPositionSizer
    from pde_tpu.signals.vol_arbitrage import VolSurfaceArbitrageSignal

    market_iv = np.asarray(jax.jit(bs_mod.implied_vol)(
        jnp.asarray(data["mid_price"], f32), 100.0,
        jnp.asarray(data["strike"], f32), 0.05, 0.02,
        jnp.asarray(data["maturity"], f32),
    ))
    chain = {
        "strike": np.asarray(data["strike"]),
        "T": np.asarray(data["maturity"]),
        "implied_vol": market_iv,
    }
    gen = VolSurfaceArbitrageSignal(use_sabr=False)
    sizer = VolatilityScaledPositionSizer()
    rets = np.random.default_rng(7).normal(0.0005, 0.012, 252)

    def pipeline():
        res = cal.calibrate(data, S0=100.0, r=0.05, q=0.02)
        sigs = gen.generate_signals(chain, 100.0, 0.05, 0.02, heston_result=res)
        return sizer.compute_position_size(rets, 1_000_000.0)

    pipeline()  # warm: compile
    t0 = time.perf_counter()
    n_reps = _n(3, 1)
    for _ in range(n_reps):
        sized = pipeline()
    per = (time.perf_counter() - t0) / n_reps
    assert sized.position_size > 0
    emit("calibration_to_sizing_pipeline_s", per, "pipeline_s", baseline=5.0)

    # 7c. daily orchestrator with EVERY stage enabled — Heston + SABR + OU +
    # Bates + rough Heston per underlying, warm-started second day (round-2
    # verdict #6).  Baseline: the reference's measured 108-quote Heston
    # stage ALONE (312 s serial scipy) — a deep LOWER bound for its full
    # daily run, since its SABR/OU stages add on top.
    from pde_tpu.calibrate.orchestrator import (CalibrationConfig,
                                                CalibrationOrchestrator)

    orch_kw = {}
    if SMOKE:  # signature-drift guard only: shrink every stage's budget
        from pde_tpu.calibrate.bates import BatesCalibrator
        from pde_tpu.calibrate.rough import RoughHestonCalibrator

        orch_kw = dict(
            heston_calibrator=HestonCalibrator(global_maxiter=4,
                                               global_popsize=4),
            rough_calibrator=RoughHestonCalibrator(n_steps=8, max_iter=2),
            bates_calibrator=BatesCalibrator(global_maxiter=2,
                                             global_popsize=4),
            rates_calibrator=HullWhiteCalibrator(max_iter=6),
            g2_calibrator=G2Calibrator(max_iter=4),
        )
    orch = CalibrationOrchestrator(CalibrationConfig(
        calibrate_heston=True, calibrate_sabr=True, calibrate_ou=True,
        calibrate_rough=True, calibrate_bates=True,
        calibrate_rates=True, calibrate_g2=True, calibrate_credit=True,
        max_options_per_underlying=128,  # keep the whole 108-quote surface
        # this process runs f32 (device bench); the bootstrap round-trip is
        # Newton-exact only to single precision here (f64 default is 1e-6)
        max_credit_roundtrip_error=5e-4,
        risk_free_rate=0.05, dividend_yield=0.02,
    ), **orch_kw)
    # rates/credit desk inputs for the new opt-in stages: the caplet strip,
    # G2 swaption panel and CDS spreads already built in sections 1i-1l
    rates_market_o = {
        "curve": hw_curve,
        "caplets": {"starts": hw_starts, "ends": hw_ends,
                    "strikes": hw_ks, "quotes": hw_quotes},
        "swaptions": {"expiries": g2_exps, "pay_times": g2_pts,
                      "strikes": g2_ks, "quotes": g2_quotes},
    }
    credit_market_o = {"curve": hw_curve, "pillars": cr_pillars,
                       "spreads": cr_spreads, "recovery": 0.4}
    market_iv_full = np.asarray(market_iv)
    chain_all = {
        "strike": np.asarray(data["strike"]),
        "T": np.asarray(data["maturity"]),
        "maturity": np.asarray(data["maturity"]),
        "mid_price": np.asarray(data["mid_price"]),
        "implied_vol": market_iv_full,
    }
    rng_o = np.random.default_rng(3)
    spread = 100.0 + np.cumsum(rng_o.normal(0, 0.5, 512))
    U_o = _n(4, 1)
    tasks = {
        f"TICK{i}": dict(market_options=chain_all, S0=100.0,
                         spread_series=spread, r=0.05, q=0.02,
                         rates_market=rates_market_o,
                         credit_market=credit_market_o)
        for i in range(U_o)
    }
    orch.run_all(tasks)  # day 1: compile + cold caches
    t0 = time.perf_counter()
    results_o = orch.run_all(tasks)  # day 2: the steady-state daily run
    per = (time.perf_counter() - t0) / U_o
    if not SMOKE:
        assert all(r.status.value != "FAILED" for r in results_o.values()), {
            k: r.errors for k, r in results_o.items()}
    emit("orchestrator_daily_all_stages_s", per, "run_s",
         baseline=_MEASURED.get("heston_surface_calibration_wall_s"))

    # 8. native host runtime: order-stream fill engine ------------------------
    from pde_tpu import native

    if native.is_available():
        rng = np.random.default_rng(1)
        n_ticks, n_orders = _n(2_000_000, 20_000), _n(1_000_000, 2_000)
        times = np.arange(n_ticks, dtype=float)
        prices = 100.0 * np.exp(np.cumsum(rng.normal(0, 0.001, n_ticks)))
        submit = np.sort(rng.uniform(0, n_ticks - 1.0, n_orders))
        sides = rng.choice([1.0, -1.0], n_orders)
        types = rng.choice([0.0, 1.0, 2.0], n_orders, p=[0.6, 0.2, 0.2])
        limits = prices[0] * (1 + rng.normal(0, 0.01, n_orders))
        qty = np.full(n_orders, 100.0)
        native.simulate_fills(times[:1000], prices[:1000], submit[:10] * 0,
                              sides[:10], types[:10] * 0, limits[:10],
                              limits[:10], qty[:10])  # warm the loader
        t0 = time.perf_counter()
        native.simulate_fills(times, prices, submit, sides, types, limits,
                              limits.copy(), qty)
        per = time.perf_counter() - t0
        emit("fill_engine_orders_per_sec", n_orders / per, "orders/s")

    # 9. serving: micro-batching pricing service (pde_tpu/serving.py).
    # Concurrent clients -> shape-bucketed device batches; measures
    # end-to-end request latency INCLUDING queueing + dispatch, the number
    # a production caller actually sees.  The reference has no serving
    # analog (callers link the OpenMP pricer in-process); baseline is its
    # measured per-call C++ price path when available.
    from concurrent.futures import ThreadPoolExecutor

    from pde_tpu.serving import BatchPricer, MicroBatchingServer, PricingRequest

    pricer = BatchPricer(buckets=(8, 32, 128, 512, 2048))
    n_req, n_clients = _n(20_000, 64), _n(32, 4)
    reqs = [
        PricingRequest(
            strike=80.0 + (i % 81) * 0.5,
            maturity=0.1 + (i % 19) * 0.1,
            spot=100.0,
            params=(2.0, 0.04, 0.3, -0.7, 0.04),
            rate=0.05,
            dividend=0.02,
            is_call=bool(i % 2),
        )
        for i in range(n_req)
    ]
    with MicroBatchingServer(pricer, max_wait_ms=2.0) as srv:
        srv.pricer.warmup(greeks=False)
        lat = np.empty(n_req)

        def client(span):
            lo, hi = span
            for i in range(lo, hi):
                t0 = time.perf_counter()
                srv.price(reqs[i], timeout=120.0)
                lat[i] = time.perf_counter() - t0

        chunk = n_req // n_clients
        spans = [(c * chunk, (c + 1) * chunk if c < n_clients - 1 else n_req)
                 for c in range(n_clients)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_clients) as pool:
            list(pool.map(client, spans))
        wall = time.perf_counter() - t0
        mean_batch = srv.stats.mean_batch
    emit("pricing_service_requests_per_sec", n_req / wall, "req/s")
    emit("pricing_service_p99_latency_ms",
         float(np.percentile(lat * 1e3, 99)), "ms")
    print(f"# serving: mean_batch={mean_batch:.1f} "
          f"p50={np.percentile(lat * 1e3, 50):.2f}ms "
          f"clients={n_clients}", file=sys.stderr)

    # 9b. LOOPBACK baseline: one synchronous
    # BatchPricer.price of a full device batch, no queueing, no threads —
    # launch + dispatch + compute + result pull.  service_p99 minus this is
    # the micro-batcher's own queueing/wait overhead.
    bucket = int(np.ceil(mean_batch)) if mean_batch > 0 else 32
    direct_reqs = reqs[:max(1, bucket)]
    lat_d = []
    for _ in range(_n(200, 3)):
        t0 = time.perf_counter()
        pricer.price(direct_reqs)
        lat_d.append(time.perf_counter() - t0)
    emit("pricing_direct_batch_p99_latency_ms",
         float(np.percentile(np.asarray(lat_d) * 1e3, 99)), "ms")
    print(f"# direct batch={len(direct_reqs)} "
          f"p50={np.percentile(np.asarray(lat_d) * 1e3, 50):.2f}ms",
          file=sys.stderr)


if __name__ == "__main__":
    main()
