#!/usr/bin/env python
"""Run pde_tpu's pricing and calibration path once on a GPU and check it.

    python chip_smoke.py          # one card: phases 1-7
    python chip_smoke.py --four   # four cards: the sharded phase only

Phases, in order, each printed on its own ``phase <name>: {...}`` line:

1. device       — JAX must find a GPU; prints its kind, the device count,
                  ``nvidia-smi`` name and power limit, and the compile cache;
2. calibration  — ``HestonCalibrator`` (DE 100 x 15 + LM) on the 108-quote
                  surface, parameters checked against the truth;
3. service      — ``MicroBatchingServer`` over ``BatchPricer``, in process,
                  every answer checked against float64 Carr-Madan;
4. heston_adi   — the fused ADI march kernel on a 512-option book, against
                  its scan twin and, for a few options, the float64 twin;
5. local_vol    — the fused local-vol march kernel on a 256-option book,
                  against its scan twin and float64 ``local_vol_pde.solve``;
6. sabr         — one SABR smile fit;
7. f64_parity   — float64 Carr-Madan on the card against the committed
                  golden values at 1e-8;
8. four         — (``--four`` only) sharded batch calibration, CVA and
                  American LSM on four cards against one card.

Every timing is the host clock around work that ends in
``block_until_ready`` (or a host result), after a warm-up call whose time
is reported as ``compile_s``.  A failed check raises: the script exits
non-zero and prints no result line.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The phases are functions of their sizes; tests/test_chip_smoke.py runs
them at tiny sizes on the CPU with the kernels in interpret mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

TRUE_HESTON = dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, v0=0.04)
S0, RATE, DIV = 100.0, 0.05, 0.02


class CheckFailed(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def progress(msg: str) -> None:
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def report(name: str, **fields) -> dict:
    print(f"phase {name}: {json.dumps(fields, default=float)}", flush=True)
    return fields


def timed(fn, reps: int):
    """(warm-up seconds, median seconds of ``reps`` calls, last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        runs.append(time.perf_counter() - t0)
    return compile_s, statistics.median(runs), out


def nvidia_smi() -> str:
    """Card name and power limit, read by a child that never imports JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------- phases

def phase_device(require: str = "gpu", smi=nvidia_smi) -> dict:
    from pde_tpu.utils.compile_cache import enable_compile_cache
    from pde_tpu.utils.profiling import device_info

    info = device_info(require=require)
    cache = enable_compile_cache()
    card = smi()
    print(card, flush=True)
    return report("device", platform=info["platform"],
                  kind=info["device_kind"], count=info["device_count"],
                  nvidia_smi=card, compile_cache=cache)


def phase_calibration(maxiter: int = 100, popsize: int = 15,
                      n_strikes: int = 12, n_maturities: int = 9,
                      param_tol: float = 1e-4, rmse_tol: float = 1e-6,
                      reps: int = 3) -> dict:
    """Recover the Heston truth from its own 108-quote surface.

    ``param_tol`` bounds |fitted - true| of every parameter and
    ``rmse_tol`` the relative RMSE of the fit (float32 on the card)."""
    from pde_tpu.calibrate import HestonCalibrator

    data = HestonCalibrator.generate_synthetic_data(
        S0=S0, r=RATE, q=DIV, **TRUE_HESTON,
        strikes=np.linspace(85.0, 115.0, n_strikes),
        maturities=np.linspace(0.25, 1.5, n_maturities),
    )
    cal = HestonCalibrator(global_maxiter=maxiter, global_popsize=popsize,
                           seed=42)
    compile_s, wall_s, res = timed(
        lambda: cal.calibrate(data, S0, RATE, DIV), reps)
    fitted = res.params._asdict()
    err = {k: abs(float(fitted[k]) - v) for k, v in TRUE_HESTON.items()}
    rel_rmse = float(res.fit_quality["relative_rmse"])
    out = report("calibration", n_quotes=len(data["strike"]),
                 compile_s=compile_s, wall_s=wall_s, rel_rmse=rel_rmse,
                 param_abs_err=err, param_tol=param_tol, rmse_tol=rmse_tol)
    check(max(err.values()) < param_tol, f"calibration params {err}")
    check(rel_rmse < rmse_tol, f"calibration rel RMSE {rel_rmse}")
    return out


SERVICE_PARAMS = ((2.0, 0.04, 0.3, -0.7, 0.04), (1.5, 0.06, 0.5, -0.5, 0.05),
                  (3.0, 0.03, 0.2, -0.9, 0.02), (1.0, 0.09, 0.6, -0.3, 0.08))


def _service_requests(n: int, rng) -> list:
    from pde_tpu.serving import PricingRequest

    reqs = []
    for i in range(n):
        reqs.append(PricingRequest(
            strike=float(rng.uniform(70.0, 130.0)),
            maturity=float(rng.choice([0.1, 0.25, 0.5, 1.0, 2.0])),
            spot=S0, params=SERVICE_PARAMS[i % len(SERVICE_PARAMS)],
            rate=RATE, dividend=DIV, is_call=bool(i % 3)))
    return reqs


def phase_service(waves=(300, 1500), require_buckets=(512, 2048),
                  tol: float = 1e-4, seed: int = 0) -> dict:
    """Concurrent mixed requests through the micro-batching server; every
    price against float64 ``price_carr_madan`` within ``tol`` (absolute).
    Each wave is submitted at once and coalesces into one micro-batch; the
    default waves fill the 512 and the 2048 shape buckets."""
    import jax
    import jax.numpy as jnp

    from pde_tpu.models import heston
    from pde_tpu.serving import BatchPricer, MicroBatchingServer

    rng = np.random.default_rng(seed)
    waves = [_service_requests(n, rng) for n in waves]
    pricer = BatchPricer()
    t0 = time.perf_counter()
    pricer.warmup(greeks=False)
    compile_s = time.perf_counter() - t0
    answers, wave_s = [], []
    server = MicroBatchingServer(pricer, max_batch=max(pricer.buckets),
                                 max_wait_ms=50.0)
    with server:
        for reqs in waves:
            t0 = time.perf_counter()
            futs = [server.submit(r) for r in reqs]
            answers += [f.result(timeout=120).price for f in futs]
            wave_s.append(time.perf_counter() - t0)
        sizes = list(server.stats.batch_sizes)
    check(server.stats.errors == 0, "service errors")

    reqs = [r for w in waves for r in w]
    with jax.enable_x64(True):
        P = jnp.asarray([r.params for r in reqs], jnp.float64)
        ref = jax.jit(jax.vmap(
            lambda p, k, t, c: heston.price_carr_madan(
                heston.HestonParams(*p), k, t, S0, RATE, DIV, c)))(
            P, jnp.asarray([r.strike for r in reqs], jnp.float64),
            jnp.asarray([r.maturity for r in reqs], jnp.float64),
            jnp.asarray([r.is_call for r in reqs]))
        ref = np.asarray(ref)
    err = float(np.max(np.abs(np.asarray(answers) - ref)))
    buckets = sorted({min(b for b in pricer.buckets if n <= b)
                      for n in sizes})
    out = report("service", n_requests=len(reqs), batch_sizes=sizes,
                 buckets_used=buckets, compile_s=compile_s, wave_s=wave_s,
                 requests_per_s=len(reqs) / sum(wave_s),
                 max_abs_err_vs_f64=err, tol=tol)
    check(err < tol, f"service max abs error {err}")
    check(set(require_buckets) <= set(buckets), f"buckets used {buckets}")
    return out


def _adi_book(B):
    k = np.linspace(85.0, 115.0, B)
    t = np.linspace(0.25, 1.5, B)
    c = (np.arange(B) % 2).astype(np.float32)
    return k, t, c


def phase_heston_adi(B: int = 512, n_spot: int = 100, n_vol: int = 50,
                     n_time: int = 100, n_f64: int = 8, tol: float = 2e-4,
                     interpret: bool = False, reps: int = 5) -> dict:
    """Fused ADI book vs its float32 scan twin (all options) and the
    float64 twin (``n_f64`` options); ``tol`` absolute on prices."""
    import jax
    import jax.numpy as jnp

    from pde_tpu.solvers import heston_adi

    f32 = jnp.float32
    k, t, c = _adi_book(B)
    grid = dict(n_spot=n_spot, n_vol=n_vol, n_time=n_time)
    hp = tuple(jnp.asarray(v, f32) for v in TRUE_HESTON.values())
    args = (*hp, jnp.asarray(RATE, f32), jnp.asarray(DIV, f32),
            jnp.asarray(t, f32), jnp.asarray(k, f32))
    compile_s, run_s, fused = timed(
        lambda: heston_adi.solve_fused_batch(
            *args, jnp.asarray(c), S0, interpret=interpret, **grid).price,
        reps)
    twin = heston_adi.solve_batch(*args, jnp.asarray(c) > 0.5,
                                  jnp.asarray(S0, f32), **grid).price
    fused = np.asarray(fused, np.float64)
    err_twin = float(np.max(np.abs(fused - np.asarray(twin, np.float64))))
    idx = np.linspace(0, B - 1, min(n_f64, B)).astype(int)
    with jax.enable_x64(True):
        ref = np.asarray(heston_adi.solve_batch(
            *TRUE_HESTON.values(), RATE, DIV, jnp.asarray(t[idx]),
            jnp.asarray(k[idx]), jnp.asarray(c[idx] > 0.5), S0, **grid).price)
    err_f64 = float(np.max(np.abs(fused[idx] - ref)))
    out = report("heston_adi", B=B, grid=[n_spot, n_vol, n_time],
                 compile_s=compile_s, run_s=run_s, options_per_s=B / run_s,
                 max_abs_err_vs_scan_f32=err_twin,
                 max_abs_err_vs_f64=err_f64, tol=tol)
    check(np.all(np.isfinite(fused)), "ADI prices not finite")
    check(err_twin < tol, f"ADI vs scan twin {err_twin}")
    check(err_f64 < tol, f"ADI vs float64 twin {err_f64}")
    return out


def _dupire(n_k, n_t):
    import jax
    import jax.numpy as jnp

    from pde_tpu.models import heston, local_vol

    params = heston.HestonParams(*TRUE_HESTON.values())
    ks = np.exp(np.linspace(np.log(60.0), np.log(170.0), n_k))
    ts = np.linspace(0.05, 1.0, n_t)
    surf = jax.jit(lambda: local_vol.dupire_surface(
        params, jnp.asarray(ks), jnp.asarray(ts), S0, 0.04, 0.01))()
    return ks, ts, np.asarray(surf, np.float64)


def phase_local_vol(B: int = 256, n_space: int = 200, n_time: int = 100,
                    n_k: int = 24, n_t: int = 6, n_f64: int = 6,
                    tol: float = 2e-4, interpret: bool = False,
                    reps: int = 5) -> dict:
    """Fused local-vol book on a Dupire surface vs its float32 scan twin
    and float64 ``local_vol_pde.solve``; ``tol`` absolute on prices."""
    import jax
    import jax.numpy as jnp

    from pde_tpu.models import local_vol
    from pde_tpu.solvers import local_vol_pde

    f32 = jnp.float32
    ks, ts, surf = _dupire(n_k, n_t)
    interp = local_vol.SurfaceInterpolator(
        jnp.asarray(ks, f32), jnp.asarray(ts, f32), jnp.asarray(surf, f32))
    K = np.linspace(70.0, 140.0, B)
    T = np.linspace(0.25, 1.5, B)
    c = (np.arange(B) % 2).astype(np.float32)
    kw = dict(K=jnp.asarray(K, f32), T=jnp.asarray(T, f32),
              is_call=jnp.asarray(c), r=0.04, q=0.01, n_space=n_space,
              n_time=n_time)
    compile_s, run_s, fused = timed(
        lambda: local_vol_pde.solve_fused_batch(
            interp, S0, interpret=interpret, **kw).price, reps)
    twin = local_vol_pde.solve_batch(interp, S0, **kw).price
    fused = np.asarray(fused, np.float64)
    err_twin = float(np.max(np.abs(fused - np.asarray(twin, np.float64))))
    idx = np.linspace(0, B - 1, min(n_f64, B)).astype(int)
    errs = []
    with jax.enable_x64(True):
        interp64 = local_vol.SurfaceInterpolator(
            jnp.asarray(ks), jnp.asarray(ts), jnp.asarray(surf))
        solve64 = jax.jit(
            lambda k, t, cp: local_vol_pde.solve(
                interp64, S0, K=k, T=t, r=0.04, q=0.01, is_call=cp,
                n_space=n_space, n_time=n_time).price,
            static_argnums=2)
        for i in idx:
            ref = float(solve64(float(K[i]), float(T[i]), bool(c[i] > 0.5)))
            errs.append(abs(fused[i] - ref))
    err_f64 = float(max(errs))
    out = report("local_vol", B=B, grid=[n_space, n_time],
                 compile_s=compile_s, run_s=run_s, options_per_s=B / run_s,
                 max_abs_err_vs_scan_f32=err_twin,
                 max_abs_err_vs_f64=err_f64, tol=tol)
    check(np.all(np.isfinite(fused)), "local-vol prices not finite")
    check(err_twin < tol, f"local-vol vs scan twin {err_twin}")
    check(err_f64 < tol, f"local-vol vs float64 solve {err_f64}")
    return out


def phase_sabr(n_strikes: int = 11, rmse_tol: float = 1e-6,
               reps: int = 5) -> dict:
    """Fit one SABR smile generated from known parameters; ``rmse_tol``
    bounds the implied-vol RMSE of the fit."""
    import jax
    import jax.numpy as jnp

    from pde_tpu.calibrate.sabr import SABRCalibrator
    from pde_tpu.models import sabr

    truth = sabr.SABRParams(0.25, 0.5, -0.35, 0.45)
    strikes = np.linspace(80.0, 120.0, n_strikes)
    F = S0 * float(np.exp(0.03))
    vols = np.asarray(jax.jit(lambda: sabr.implied_volatilities(
        jnp.asarray(strikes, jnp.float32), F, 1.0, truth))())
    cal = SABRCalibrator(beta=0.5)
    compile_s, fit_s, (fit, rmse) = timed(
        lambda: cal.calibrate_single_maturity(strikes, vols, F, 1.0), reps)
    out = report("sabr", n_strikes=n_strikes, compile_s=compile_s,
                 fit_s=fit_s, rmse=float(rmse), rmse_tol=rmse_tol,
                 params=[float(fit.alpha), float(fit.rho), float(fit.nu)])
    check(float(rmse) < rmse_tol, f"SABR RMSE {rmse}")
    return out


def phase_f64_parity(tol: float = 1e-8) -> dict:
    """float64 Carr-Madan on the default device against
    tests/golden/reference_values.json (the C++ reference engine)."""
    import pathlib

    import jax
    import jax.numpy as jnp

    from pde_tpu.models import heston

    golden = json.loads((pathlib.Path(__file__).parent / "tests" / "golden"
                         / "reference_values.json").read_text())
    cases = {
        "heston_call_atm_T1": (100.0, 1.0, RATE, DIV, True),
        "heston_put_atm_T1": (100.0, 1.0, RATE, DIV, False),
        "heston_call_k80_T025": (80.0, 0.25, RATE, DIV, True),
        "heston_call_k120_T2": (120.0, 2.0, RATE, DIV, True),
        "heston_call_k90_T05_q0": (90.0, 0.5, 0.03, 0.0, True),
    }
    with jax.enable_x64(True):
        p = heston.HestonParams(*TRUE_HESTON.values())
        price = jax.jit(heston.price_carr_madan,
                        static_argnames=("is_call",))
        errs = {name: abs(float(price(p, k, t, S0, r, q, is_call=c))
                          - golden[name])
                for name, (k, t, r, q, c) in cases.items()}
        sweep = price(p, jnp.linspace(80.0, 120.0, 100), 1.0, S0, RATE, DIV,
                      is_call=True)
        check(sweep.dtype == jnp.float64, "sweep not float64")
        errs["heston_strikes_T1"] = float(np.max(np.abs(
            np.asarray(sweep) - np.asarray(golden["heston_strikes_T1"]))))
        platform = next(iter(sweep.devices())).platform
    out = report("f64_parity", platform=platform, max_abs_err=errs, tol=tol)
    check(max(errs.values()) < tol, f"float64 parity {errs}")
    return out


def phase_four(n_devices: int = 4, n_surfaces: int = 16, n_quotes: int = 16,
               maxiter: int = 30, popsize: int = 8, n_paths: int = 65536,
               lsm_paths: int = 65536, cva_tol: float = 0.03) -> dict:
    """Sharded batch calibration, CVA and American LSM over ``n_devices``
    cards, each against the same call on one card with the same seeds.

    The sharded calibration must match one card's to 1e-3 relative; the
    two CVA estimates (different path shards) must agree with each other
    and with the float64 closed form within ``cva_tol`` relative; the two
    LSM prices within 4 combined standard errors."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pde_tpu.calibrate import HestonCalibrator
    from pde_tpu.models import credit, heston, rates
    from pde_tpu.parallel.mc import (cva_netting_sharded,
                                     price_american_lsm_sharded)
    from pde_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= n_devices,
          f"--four needs {n_devices} devices, found {len(jax.devices())}")
    mesh = make_mesh(n_devices, shape=(n_devices, 1))
    probe = jax.device_put(jnp.arange(4 * n_devices),
                           NamedSharding(mesh, P("dp")))
    placed = {s.device.id for s in probe.addressable_shards}
    check(len(placed) == n_devices, f"shards placed on {placed}")

    # batch calibration over underlyings: dp shards, single card reference
    truth = np.array(list(TRUE_HESTON.values()))
    scale = np.linspace(0.8, 1.2, n_surfaces)[:, None]
    tr = np.tile(truth, (n_surfaces, 1))
    tr[:, 1] *= scale[:, 0]
    tr[:, 4] *= scale[:, 0]
    strikes = np.tile(np.linspace(85.0, 115.0, n_quotes), (n_surfaces, 1))
    mats = np.tile(np.repeat([0.5, 1.0], n_quotes // 2), (n_surfaces, 1))
    price = jax.jit(jax.vmap(lambda p, k, t: heston.price_options(
        heston.HestonParams(*p), k, t, S0, RATE, DIV)))
    prices = np.maximum(np.asarray(price(jnp.asarray(tr), jnp.asarray(strikes),
                                         jnp.asarray(mats))), 0.01)
    cal = HestonCalibrator(global_maxiter=maxiter, global_popsize=popsize,
                           local_max_iter=20)
    spot = np.full(n_surfaces, S0)
    progress("four: calibrate_batch on one device")
    t0 = time.perf_counter()
    one = cal.calibrate_batch(strikes, mats, prices, spot, RATE, DIV)
    p1 = np.asarray(one["params"])
    t_one = time.perf_counter() - t0
    progress("four: calibrate_batch on the mesh")
    t0 = time.perf_counter()
    many = cal.calibrate_batch(strikes, mats, prices, spot, RATE, DIV,
                               mesh=mesh)
    p4 = np.asarray(many["params"])
    t_many = time.perf_counter() - t0
    cal_diff = float(np.max(np.abs(p4 - p1) / np.maximum(np.abs(p1), 1e-3)))

    # netting-set CVA, exposure paths sharded
    curve = rates.curve_from_zero_rates(jnp.array([1.0, 5.0, 10.0]),
                                        jnp.array([0.03, 0.04, 0.042]))
    hw = rates.HullWhiteParams(jnp.asarray(0.1), jnp.asarray(0.012), curve)
    sched = jnp.arange(0.5, 3.01, 0.5)
    K = rates.hw_swap_rate(curve, 0.5, sched[1:])
    hz = credit.flat_hazard(0.02)
    trade = credit.SwapTrade(K, jnp.asarray(1.0), jnp.asarray(1.0))
    mesh_1d = make_mesh(n_devices, axis_names=("dp",), shape=(n_devices,))
    mesh_one = make_mesh(1, axis_names=("dp",), shape=(1,))
    key = jax.random.PRNGKey(0)
    progress("four: CVA")
    cva4, _ = cva_netting_sharded(hw, hz, [trade], sched, key, mesh_1d,
                                  n_paths=n_paths)
    cva1, _ = cva_netting_sharded(hw, hz, [trade], sched, key, mesh_one,
                                  n_paths=n_paths)
    cva4, cva1 = float(cva4), float(cva1)
    with jax.enable_x64(True):
        # the closed form (a Jamshidian swaption strip) loses several per
        # cent in float32, so the reference runs in float64
        curve64 = rates.curve_from_zero_rates(
            jnp.array([1.0, 5.0, 10.0], jnp.float64),
            jnp.array([0.03, 0.04, 0.042], jnp.float64))
        hw64 = rates.HullWhiteParams(jnp.asarray(0.1, jnp.float64),
                                     jnp.asarray(0.012, jnp.float64), curve64)
        sched64 = jnp.arange(0.5, 3.01, 0.5, dtype=jnp.float64)
        cva_cf = float(credit.cva_swap_hw(
            hw64, credit.flat_hazard(0.02), rates.hw_swap_rate(
                curve64, 0.5, sched64[1:]), sched64))

    # American put by path-sharded LSM
    hp = heston.HestonParams(*TRUE_HESTON.values())
    lkey = jax.random.PRNGKey(11)
    progress("four: American LSM")
    a4, se4 = price_american_lsm_sharded(hp, 100.0, 1.0, S0, lkey, mesh_1d,
                                         rate=RATE, is_call=False,
                                         n_steps=32, n_paths=lsm_paths)
    a1, se1 = price_american_lsm_sharded(hp, 100.0, 1.0, S0, lkey, mesh_one,
                                         rate=RATE, is_call=False,
                                         n_steps=32, n_paths=lsm_paths)
    a4, a1 = float(a4), float(a1)
    lsm_tol = 4.0 * float(np.hypot(float(se4), float(se1)))

    out = report("four", devices=n_devices, shards_on=sorted(placed),
                 calibrate_batch=dict(surfaces=n_surfaces, wall_1_s=t_one,
                                      wall_4_s=t_many,
                                      max_rel_param_diff=cal_diff),
                 cva=dict(one=cva1, four=cva4, closed_form_f64=cva_cf,
                          rel_tol=cva_tol),
                 american_lsm=dict(one=a1, four=a4, tol=lsm_tol))
    check(cal_diff < 1e-3, f"sharded calibration differs by {cal_diff}")
    check(abs(cva4 / cva1 - 1.0) < cva_tol
          and abs(cva4 / cva_cf - 1.0) < cva_tol
          and abs(cva1 / cva_cf - 1.0) < cva_tol,
          f"CVA one={cva1} four={cva4} float64 closed form={cva_cf}")
    check(abs(a4 - a1) < lsm_tol, f"LSM one={a1} four={a4} tol={lsm_tol}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run the pricing and calibration path on the GPU.")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = phase_device()
    if args.four:
        phase_four()
    else:
        phase_calibration()
        phase_service()
        phase_heston_adi()
        phase_local_vol()
        phase_sabr()
        phase_f64_parity()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
