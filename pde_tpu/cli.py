"""`pde-tpu` command-line interface.

Mirrors the reference CLI (cli.py:1277-1432) — its ten subcommands
(backtest, calibrate, status, config, demo, portfolio, scan,
sector-portfolio, rolling-backtest, optimize-sectors) plus `price`, which
exposes the pricing stack directly.  Market data comes
from the configured provider (the deterministic simulated provider by
default, since this build targets zero-egress environments; point
--provider at a REST provider for live data).
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import date, timedelta
from typing import Dict, List, Optional

import numpy as np

from .core.config import Config, load_config
from .trading_system import TradingSystem

__all__ = ["main", "build_parser"]


def _get_prices(symbols: List[str], days: int, provider_name: str = "simulated", seed: int = 42) -> Dict[str, np.ndarray]:
    from .data.providers import create_provider

    provider = create_provider(provider_name, **({"seed": seed} if provider_name == "simulated" else {}))
    end = date.today()
    start = end - timedelta(days=days)
    return {
        s: np.array([b.close for b in provider.get_bars(s, start, end)])
        for s in symbols
    }


def cmd_backtest(args) -> int:
    system = TradingSystem(load_config(args.config))
    prices = _get_prices(args.symbols, args.days, args.provider, args.seed)
    params = {}
    if args.strategy == "ma_crossover":
        params = {"short_window": args.short_window, "long_window": args.long_window}
    results = system.run_backtest(prices, strategy=args.strategy, **params)
    print(results.summary())
    if args.json:
        print(json.dumps({
            "total_return_pct": results.total_return_pct,
            "sharpe_ratio": results.sharpe_ratio,
            "max_drawdown_pct": results.max_drawdown_pct,
            "n_trades": results.n_trades,
        }))
    return 0


def cmd_calibrate(args) -> int:
    from .calibrate import HestonCalibrator

    data = HestonCalibrator.generate_synthetic_data(
        S0=args.spot, r=args.rate, q=args.dividend,
        n_strikes=args.n_strikes, n_maturities=args.n_maturities,
    )
    cal = HestonCalibrator(global_maxiter=args.maxiter, global_popsize=args.popsize)
    res = cal.calibrate(data, S0=args.spot, r=args.rate, q=args.dividend,
                        underlying=args.underlying)
    print(json.dumps(res.to_dict(), default=str, indent=2))
    return 0 if res.success else 1


def cmd_price(args) -> int:
    """Price a strike grid under Heston: Carr-Madan CF, the ADI PDE, or
    adjoint Greeks — the pricing stack as a CLI surface."""
    import numpy as np

    strikes = np.asarray(args.strikes, dtype=float)
    out = {"model": "heston", "method": args.method, "spot": args.spot,
           "maturity": args.maturity, "strikes": strikes.tolist()}

    if args.method == "cf":
        import jax.numpy as jnp

        from .models import heston

        params = heston.HestonParams(
            kappa=args.kappa, theta=args.theta, sigma=args.sigma,
            rho=args.rho, v0=args.v0,
        )
        prices = heston.price_accurate(
            params, jnp.asarray(strikes), args.maturity, args.spot,
            args.rate, args.dividend, is_call=not args.put,
        )
        ivs = heston.implied_volatility(
            params, jnp.asarray(strikes), jnp.asarray(args.maturity),
            args.spot, args.rate, args.dividend, not args.put, accurate=True,
        )
        out["prices"] = np.asarray(prices).tolist()
        out["implied_vols"] = np.asarray(ivs).tolist()
    elif args.method == "pde":
        from .solvers import heston_adi

        res = heston_adi.solve_batch(
            args.kappa, args.theta, args.sigma, args.rho, args.v0,
            args.rate, args.dividend, args.maturity, strikes,
            not args.put, args.spot, american=args.american,
        )
        out["prices"] = np.asarray(res.price).tolist()
        out["delta"] = np.asarray(res.delta).tolist()
        out["gamma"] = np.asarray(res.gamma).tolist()
        out["american"] = args.american
    elif args.method == "digital":
        import jax.numpy as jnp

        from .models import digital, heston

        params = heston.HestonParams(
            kappa=args.kappa, theta=args.theta, sigma=args.sigma,
            rho=args.rho, v0=args.v0,
        )
        k = jnp.asarray(strikes)
        # one Gil-Pelaez pass (two CF contours) feeds probabilities AND both
        # digital prices — not three separate pricing calls
        p1, p2 = digital.probabilities(
            params, k, args.maturity, args.spot, args.rate, args.dividend)
        cash, asset = digital.prices_from_probs(
            p1, p2, k, args.maturity, args.spot, args.rate, args.dividend,
            is_call=not args.put)
        out["cash"] = np.asarray(cash).tolist()
        out["asset"] = np.asarray(asset).tolist()
        out["p1"] = np.asarray(p1).tolist()
        out["p2"] = np.asarray(p2).tolist()
    else:  # greeks
        import jax

        from .solvers import heston_adi

        rows = []
        for K in strikes:
            g = heston_adi.greeks_ad(
                args.kappa, args.theta, args.sigma, args.rho, args.v0,
                args.rate, args.dividend, args.maturity, float(K),
                not args.put, args.spot,
            )
            rows.append({k: float(v) for k, v in jax.device_get(g).items()})
        out["greeks"] = rows

    print(json.dumps(out, indent=2))
    return 0


def cmd_varswap(args) -> int:
    """Variance/volatility-swap fair strikes from model parameters
    (models/varswap.py) — jumps included when --lam > 0."""
    import numpy as np

    from .models import varswap
    from .models.heston import HestonParams

    if args.lam > 0:
        from .models.bates import BatesParams

        params = BatesParams(args.kappa, args.theta, args.sigma, args.rho,
                             args.v0, args.lam, args.mu_j, args.sigma_j)
        model = "bates"
    else:
        params = HestonParams(args.kappa, args.theta, args.sigma, args.rho,
                              args.v0)
        model = "heston"

    rows = []
    for T in args.maturities:
        kvar = float(varswap.fair_variance_strike(params, T))
        kvol = float(varswap.fair_volatility_strike(params, T))
        rows.append({
            "maturity": T,
            "variance_strike": kvar,
            "variance_strike_vol_points": float(np.sqrt(kvar)) * 100.0,
            "volatility_strike_exact": kvol,
            "volatility_strike_approx": float(
                varswap.volatility_convexity_approx(params, T)),
            "convexity_discount_vol_points": (np.sqrt(kvar) - kvol) * 100.0,
        })
    out = {"model": model, "strikes": rows}
    if len(args.maturities) >= 2:
        t1, t2 = args.maturities[0], args.maturities[-1]
        out["forward_variance"] = {
            "t1": t1, "t2": t2,
            "strike": float(varswap.forward_variance(params, t1, t2)),
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_pide(args) -> int:
    """Jump-diffusion option strip through the PIDE solver
    (solvers/pide.py): Merton lognormal or Kou double-exponential jumps,
    European or American, one IMEX march for the whole strip."""
    from .solvers import pide

    if args.jumps == "merton":
        jumps = pide.MertonJumps(args.lam, args.mu_j, args.sigma_j)
        jrow = {"family": "merton", "lam": args.lam, "mu_j": args.mu_j,
                "sigma_j": args.sigma_j}
    else:
        jumps = pide.KouJumps(args.lam, args.p_up, args.eta1, args.eta2)
        jrow = {"family": "kou", "lam": args.lam, "p_up": args.p_up,
                "eta1": args.eta1, "eta2": args.eta2}
    res = pide.solve_pide(
        jumps, args.vol, args.rate, args.dividend, args.maturity,
        args.strikes, args.spot, is_call=not args.put,
        american=args.american,
        n_space=args.n_space, n_time=args.n_time,
    )
    out = {
        "model": "jump_diffusion_pide",
        "jumps": jrow,
        "style": "american" if args.american else "european",
        "side": "put" if args.put else "call",
        "spot": args.spot,
        "maturity": args.maturity,
        "rows": [
            {"strike": k, "price": float(p), "delta": float(d),
             "gamma": float(g)}
            for k, p, d, g in zip(args.strikes, res.price, res.delta,
                                  res.gamma)
        ],
    }
    if args.oracle_check and not args.american:
        import numpy as np

        if args.jumps == "merton":
            from .models.bates import merton_reference_price

            ref = merton_reference_price(
                np.asarray(args.strikes), args.maturity, args.spot,
                args.rate, args.dividend, args.vol,
                args.lam, args.mu_j, args.sigma_j, is_call=not args.put)
        else:
            ref = pide.kou_reference_price(
                np.asarray(args.strikes), args.maturity, args.spot,
                args.rate, args.dividend, args.vol,
                args.lam, args.p_up, args.eta1, args.eta2,
                is_call=not args.put)
        err = np.abs(np.array(res.price) - ref)
        out["oracle_max_abs_err"] = float(err.max())
    print(json.dumps(out, indent=2))
    return 0


def cmd_vix(args) -> int:
    """VIX futures and options from model parameters (models/vix.py) —
    exact CIR terminal law; Bates jump strip premium when --lam > 0."""
    from .models import vix

    if args.lam > 0:
        from .models.bates import BatesParams

        params = BatesParams(args.kappa, args.theta, args.sigma, args.rho,
                             args.v0, args.lam, args.mu_j, args.sigma_j)
        model = "bates"
    else:
        from .models.heston import HestonParams

        params = HestonParams(args.kappa, args.theta, args.sigma, args.rho,
                              args.v0)
        model = "heston"

    out = {
        "model": model,
        "spot_vix": float(vix.vix_spot(params)),
        "futures": [
            {"maturity": T, "price": float(vix.vix_futures(params, T))}
            for T in args.maturities
        ],
    }
    if args.strikes:
        import jax.numpy as jnp

        T = args.maturities[0]
        fut = float(vix.vix_futures(params, T))
        ks = jnp.asarray(args.strikes)
        calls = vix.vix_option(params, ks, T, args.rate, is_call=not args.put)
        ivs = vix.vix_implied_vol(calls, fut, ks, T, args.rate,
                                  is_call=not args.put)
        out["options"] = {
            "maturity": T,
            "type": "put" if args.put else "call",
            "futures": fut,
            "rows": [
                {"strike": float(k), "price": float(p), "black76_iv": float(iv)}
                for k, p, iv in zip(np.asarray(ks), np.asarray(calls),
                                    np.asarray(ivs))
            ],
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_rates(args) -> int:
    """Hull-White rates desk: discount curve, caplet strip, ATM swaption
    panel from (a, sigma) over a zero-curve (models/rates.py)."""
    import jax.numpy as jnp

    from .models import rates

    times = np.asarray(args.curve_times)
    zeros = np.asarray(args.curve_zeros)
    if times.shape != zeros.shape:
        print("error: --curve-times and --curve-zeros must align",
              file=sys.stderr)
        return 2
    curve = rates.curve_from_zero_rates(times, zeros)
    hw = rates.HullWhiteParams(jnp.asarray(args.a), jnp.asarray(args.sigma),
                               curve).validate()
    starts = np.asarray(args.caplet_starts)
    ends = starts + args.caplet_tenor
    fwds = np.asarray(curve.forward(starts, ends))
    caplets = np.asarray(rates.hw_caplet(hw, jnp.asarray(fwds), starts, ends))
    out = {
        "model": "hull-white",
        "a": args.a,
        "sigma": args.sigma,
        "curve": [{"t": float(t), "df": float(curve.df(t))} for t in times],
        "atm_caplets": [
            {"start": float(s), "end": float(e), "forward": float(f),
             "price": float(c)}
            for s, e, f, c in zip(starts, ends, fwds, caplets)
        ],
    }
    panel = []
    for e in args.swaption_expiries:
        pay = np.arange(e + 0.5, e + args.swap_tenor + 0.01, 0.5)
        par = float(rates.hw_swap_rate(curve, e, jnp.asarray(pay)))
        price = float(rates.hw_swaption(hw, par, e, jnp.asarray(pay)))
        panel.append({"expiry": float(e), "tenor": args.swap_tenor,
                      "par_rate": par, "payer_price": price})
    out["atm_swaptions"] = panel
    if args.bermudan:
        from .solvers import bermudan_hw

        e0 = args.swaption_expiries[0]
        sched = jnp.asarray(
            np.arange(e0, e0 + args.swap_tenor + 0.01, 0.5))
        par = float(rates.hw_swap_rate(curve, e0, sched[1:]))
        price, _, _ = bermudan_hw.bermudan_swaption_pde(
            hw, par, sched, n_x=301, n_sub=12)
        euro = float(rates.hw_swaption(hw, par, e0, sched[1:]))
        out["atm_bermudan"] = {
            "first_call": float(e0), "tenor": args.swap_tenor,
            "par_rate": par, "payer_price": float(price),
            "european_price": euro,
            "early_exercise_premium": float(price) - euro,
        }
    if args.cap_vols is not None:
        # market cap vols -> forward caplet vols -> prices -> HW refit:
        # the full quote-to-calibration path (models/rates.py stripping)
        from .calibrate.rates import HullWhiteCalibrator

        mats = list(args.cap_maturities)[:len(args.cap_vols)]
        k_cap = args.cap_strike
        if k_cap is None:
            pay = np.arange(0.5, mats[-1] + 0.01, 0.5)
            k_cap = float(rates.hw_swap_rate(curve, 0.5, jnp.asarray(pay)))
        c_starts, c_ends, fwd = rates.strip_caplet_vols(
            curve, k_cap, mats, jnp.asarray(args.cap_vols))
        prices = rates.black_caplet_price(curve, k_cap, c_starts, c_ends,
                                          fwd)
        fit = HullWhiteCalibrator().calibrate_caplets(
            curve, c_starts, c_ends,
            jnp.full(c_starts.shape, k_cap), prices)
        out["cap_vol_strip"] = {
            "strike": k_cap,
            "forward_vols": [
                {"start": float(s), "end": float(e), "vol": float(v),
                 "price": float(p)}
                for s, e, v, p in zip(np.asarray(c_starts),
                                      np.asarray(c_ends),
                                      np.asarray(fwd), np.asarray(prices))
            ],
            "fitted": {"a": float(fit.params.a),
                       "sigma": float(fit.params.sigma),
                       "rmse": fit.rmse,
                       "converged": fit.converged},
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_credit(args) -> int:
    """Credit desk: CDS hazard bootstrap from par spreads, survival/
    hazard readout, and CVA of an ATM payer swap vs the bootstrapped
    counterparty (models/credit.py)."""
    import jax.numpy as jnp

    from .models import credit, rates

    times = np.asarray(args.curve_times)
    zeros = np.asarray(args.curve_zeros)
    pillars = np.asarray(args.pillars)
    spreads = np.asarray(args.spreads)
    if times.shape != zeros.shape:
        print("error: --curve-times and --curve-zeros must align",
              file=sys.stderr)
        return 2
    if pillars.shape != spreads.shape:
        print("error: --pillars and --spreads must align", file=sys.stderr)
        return 2
    curve = rates.curve_from_zero_rates(times, zeros)
    hc, hs = credit.bootstrap_hazard(
        curve, pillars, spreads, recovery=args.recovery)
    out = {
        "model": "cds-hazard",
        "recovery": args.recovery,
        "pillars": [
            {"t": float(t), "spread": float(s), "hazard": float(h),
             "survival": float(q)}
            for t, s, h, q in zip(pillars, spreads, np.asarray(hs),
                                  np.asarray(hc.survival))
        ],
    }
    if args.cva_tenor > 0:
        hw = rates.HullWhiteParams(
            jnp.asarray(args.a), jnp.asarray(args.sigma), curve)
        sched = jnp.asarray(
            np.arange(0.5, args.cva_tenor + 0.01, 0.5))
        k = float(rates.hw_swap_rate(curve, 0.5, sched[1:]))
        cva = float(credit.cva_swap_hw(
            hw, hc, k, sched, recovery=args.recovery))
        out["cva_atm_payer_swap"] = {
            "tenor": args.cva_tenor, "par_rate": k, "cva": cva,
            "hw_a": args.a, "hw_sigma": args.sigma,
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_fwdstart(args) -> int:
    """Forward-start vanillas / cliquet strips from model parameters
    (models/forward_start.py analytic route; models/heston_mc.py MC
    cross-check when --mc-check is given)."""
    from .models import forward_start
    from .models.heston import HestonParams

    params = HestonParams(args.kappa, args.theta, args.sigma, args.rho,
                          args.v0)
    rows = []
    for k in args.rel_strikes:
        price = float(forward_start.price_forward_start(
            params, k, args.fixing, args.maturity,
            rate=args.rate, dividend=args.dividend, is_call=not args.put))
        row = {"rel_strike": k, "price": price}
        if args.mc_check:
            import jax

            from .models import heston_mc

            pm, err = heston_mc.price_forward_start_mc(
                params, k, args.fixing, args.maturity, 100.0,
                jax.random.PRNGKey(0), rate=args.rate,
                dividend=args.dividend, is_call=not args.put,
                n_steps=64, n_paths=65536)
            row["mc_price"] = float(pm)
            row["mc_stderr"] = float(err)
        rows.append(row)
    out = {"model": "heston", "fixing": args.fixing,
           "maturity": args.maturity, "forward_starts": rows}
    if args.cliquet_periods:
        out["cliquet_strip"] = {
            "n_periods": args.cliquet_periods,
            "local_floor": args.local_floor,
            "local_cap": args.local_cap,
            "price": float(forward_start.price_cliquet_strip(
                params, args.maturity, n_periods=args.cliquet_periods,
                local_floor=args.local_floor, local_cap=args.local_cap,
                rate=args.rate, dividend=args.dividend)),
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_status(args) -> int:
    system = TradingSystem(load_config(args.config))
    status = system.initialize()
    # init success/failure per component must survive the merge —
    # get_status() also has a "components" key (a bare name list)
    print(json.dumps({**system.get_status(), "components": status},
                     default=str, indent=2))
    return 0


def cmd_config(args) -> int:
    cfg = load_config(args.config)
    if args.save:
        cfg.save(args.save)
        print(f"saved config to {args.save}")
    else:
        print(json.dumps(cfg.to_dict(), indent=2, default=str))
    return 0


def cmd_demo(args) -> int:
    """End-to-end demo: calibrate -> signals -> backtest (cli.py:275-389)."""
    from .calibrate import HestonCalibrator, OUFitter
    from .signals import MeanReversionSignalGenerator, SignalAggregator, VolSurfaceArbitrageSignal

    print("== pde_tpu demo ==")
    print("1) calibrating Heston to a synthetic surface...")
    data = HestonCalibrator.generate_synthetic_data(n_strikes=9, n_maturities=2)
    cal = HestonCalibrator(global_maxiter=25, global_popsize=8)
    hres = cal.calibrate(data, S0=100.0, r=0.05, q=0.02)
    print(f"   rmse={hres.rmse:.4f} params kappa={hres.params.kappa:.2f} v0={hres.params.v0:.4f}")

    print("2) fitting OU to a synthetic spread...")
    spread = OUFitter.generate_synthetic_data(n_points=750, seed=args.seed)
    oures = OUFitter().fit(spread)
    print(f"   mu={oures.params.mu:.2f} half-life={float(oures.params.half_life()) * 252:.1f}d")

    print("3) generating signals...")
    chain = {
        "underlying": ["DEMO"] * 7,
        "strike": np.linspace(92, 108, 7),
        "T": np.full(7, 45 / 365),
        "implied_vol": np.full(7, 0.15),
        "option_type": ["call"] * 7,
    }
    vsigs = VolSurfaceArbitrageSignal(use_sabr=False).generate_signals(
        chain, 100.0, 0.05, 0.02, heston_result=hres
    )
    msig = MeanReversionSignalGenerator().generate_signal(
        "DEMO-SPREAD", oures.boundaries.entry_lower - 0.05, oures
    )
    final = SignalAggregator().aggregate(
        vol_arbitrage_signals=vsigs,
        mean_reversion_signals=[msig] if msig else [],
    )
    for s in final:
        print(f"   {s.asset}: {s.signal_type.value} conf={s.confidence:.2f} "
              f"size=${s.suggested_position_size:,.0f}")

    print("4) running a quick backtest...")
    system = TradingSystem()
    prices = _get_prices(["DEMO"], 400, seed=args.seed)
    results = system.run_backtest(prices, strategy="ma_crossover")
    print(results.summary())
    return 0


def cmd_portfolio(args) -> int:
    system = TradingSystem(load_config(args.config))
    system.initialize()
    print(json.dumps(system.get_status(), default=str, indent=2))
    return 0


def cmd_scan(args) -> int:
    """Scan a universe for mean-reversion candidates (cli.py scan handler)."""
    from .calibrate import OUFitter

    prices = _get_prices(args.symbols, args.days, args.provider, args.seed)
    fitter = OUFitter()
    rows = []
    for symbol, series in prices.items():
        if len(series) < 50:
            continue
        res = fitter.fit(np.log(series))
        hl_days = float(res.params.half_life()) * 252.0
        rows.append({
            "symbol": symbol,
            "mu": round(float(res.params.mu), 3),
            "half_life_days": round(hl_days, 1),
            "candidate": bool(res.success and 5.0 <= hl_days <= 120.0),
        })
    rows.sort(key=lambda r: r["half_life_days"])
    print(json.dumps(rows, indent=2))
    return 0


def cmd_sector_portfolio(args) -> int:
    from .backtest.sectors import ConfidenceCalculator, calculate_position_size, get_sector

    prices = _get_prices(args.symbols, args.days, args.provider, args.seed)
    calc = ConfidenceCalculator()
    out = []
    for symbol, series in prices.items():
        m = calc.calculate(symbol, series, signal_strength=0.6, strategy_agreement=0.6)
        out.append({
            "symbol": symbol,
            "sector": get_sector(symbol).value,
            "confidence": round(m.confidence, 3),
            "position": round(calculate_position_size(m.confidence, args.capital), 0),
        })
    out.sort(key=lambda r: -r["confidence"])
    print(json.dumps(out, indent=2))
    return 0


def cmd_rolling_backtest(args) -> int:
    from .backtest.optimizer import RollingOptimizationBacktester, StrategyOptimizer, STRATEGY_FAMILIES

    prices = _get_prices([args.symbol], args.days, args.provider, args.seed)[args.symbol]
    strategies = {k: STRATEGY_FAMILIES[k] for k in (args.strategies or list(STRATEGY_FAMILIES))}
    rb = RollingOptimizationBacktester(
        StrategyOptimizer(strategies=strategies),
        opt_window=args.opt_window, trade_window=args.trade_window,
    )
    res = rb.run(prices)
    print(res.summary())
    for p in res.periods:
        print(f"  period {p.period_id}: {p.chosen_strategy} {p.chosen_params} "
              f"ret={p.period_return:+.2%}")
    return 0


def cmd_optimize_sectors(args) -> int:
    from .backtest.optimizer import StrategyOptimizer
    from .backtest.sectors import get_sector

    prices = _get_prices(args.symbols, args.days, args.provider, args.seed)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for symbol, series in prices.items():
        groups.setdefault(get_sector(symbol).value, {})[symbol] = series
    opt = StrategyOptimizer(cache_path=args.cache)
    results = opt.run_optimization(groups)
    summary = {
        g: {name: {"fitness": round(fr.fitness, 3), "params": fr.params}
            for name, fr in cells.items()}
        for g, cells in results.items()
    }
    print(json.dumps(summary, indent=2))
    return 0


def cmd_serve(args) -> int:
    """Run the micro-batching pricing service (pde_tpu/serving.py) —
    the container entrypoint, reachable from the command line too."""
    from .serving import run_server

    run_server(host=args.host, port=args.port, max_wait_ms=args.max_wait_ms)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pde-tpu",
                                     description="JAX quantitative pricing and trading framework")
    parser.add_argument("--config", default=None, help="config file (json/yaml)")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--provider", default="simulated")
        p.add_argument("--days", type=int, default=400)
        p.add_argument("--seed", type=int, default=42)
        p.set_defaults(config=None)
        return p

    p = common(sub.add_parser("backtest", help="run a backtest"))
    p.add_argument("--symbols", nargs="+", default=["SPY"])
    p.add_argument("--strategy", default="ma_crossover",
                   choices=["buy_and_hold", "ma_crossover", "mean_reversion", "momentum"])
    p.add_argument("--short-window", type=int, default=20, dest="short_window")
    p.add_argument("--long-window", type=int, default=50, dest="long_window")
    p.add_argument("--json", action="store_true")
    p.set_defaults(func=cmd_backtest)

    p = sub.add_parser("calibrate", help="calibrate Heston to a surface")
    p.add_argument("--underlying", default="SYNTHETIC")
    p.add_argument("--spot", type=float, default=100.0)
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--dividend", type=float, default=0.02)
    p.add_argument("--n-strikes", type=int, default=11, dest="n_strikes")
    p.add_argument("--n-maturities", type=int, default=3, dest="n_maturities")
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--popsize", type=int, default=15)
    p.set_defaults(func=cmd_calibrate, config=None)

    p = sub.add_parser("price", help="price a strike grid (Heston CF/PDE/AD-Greeks/digitals)")
    p.add_argument("--method", choices=("cf", "pde", "greeks", "digital"), default="cf")
    p.add_argument("--strikes", type=float, nargs="+", default=[90.0, 100.0, 110.0])
    p.add_argument("--spot", type=float, default=100.0)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--dividend", type=float, default=0.0)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--sigma", type=float, default=0.3)
    p.add_argument("--rho", type=float, default=-0.7)
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--put", action="store_true", help="price puts instead of calls")
    p.add_argument("--american", action="store_true", help="PDE method: American exercise")
    p.set_defaults(func=cmd_price, config=None)

    p = sub.add_parser("varswap", help="variance/vol-swap fair strikes (Heston/Bates)")
    p.add_argument("--maturities", type=float, nargs="+", default=[0.25, 0.5, 1.0])
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--sigma", type=float, default=0.3)
    p.add_argument("--rho", type=float, default=-0.7)
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--lam", type=float, default=0.0, help="jump intensity (Bates when > 0)")
    p.add_argument("--mu-j", dest="mu_j", type=float, default=-0.1)
    p.add_argument("--sigma-j", dest="sigma_j", type=float, default=0.15)
    p.set_defaults(func=cmd_varswap, config=None)

    p = sub.add_parser("vix", help="VIX futures/options (exact CIR terminal law)")
    p.add_argument("--maturities", type=float, nargs="+", default=[0.0833, 0.25, 0.5])
    p.add_argument("--strikes", type=float, nargs="+", default=None,
                   help="VIX option strikes (VIX points); options are priced "
                        "at the FIRST maturity only")
    p.add_argument("--rate", type=float, default=0.0)
    p.add_argument("--put", action="store_true", help="price puts instead of calls")
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--sigma", type=float, default=0.3)
    p.add_argument("--rho", type=float, default=-0.7)
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--lam", type=float, default=0.0, help="jump intensity (Bates when > 0)")
    p.add_argument("--mu-j", dest="mu_j", type=float, default=-0.1)
    p.add_argument("--sigma-j", dest="sigma_j", type=float, default=0.15)
    p.set_defaults(func=cmd_vix, config=None)

    p = sub.add_parser("rates", help="Hull-White curve/caplets/swaptions")
    p.add_argument("--a", type=float, default=0.1, help="mean reversion")
    p.add_argument("--sigma", type=float, default=0.012)
    p.add_argument("--curve-times", type=float, nargs="+",
                   default=[0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
    p.add_argument("--curve-zeros", type=float, nargs="+",
                   default=[0.030, 0.032, 0.035, 0.040, 0.042, 0.043],
                   help="continuously-compounded zero rates at the pillars")
    p.add_argument("--caplet-starts", type=float, nargs="+",
                   default=[0.5, 1.0, 2.0, 3.0, 5.0])
    p.add_argument("--caplet-tenor", type=float, default=0.5)
    p.add_argument("--swaption-expiries", type=float, nargs="+",
                   default=[1.0, 2.0, 5.0])
    p.add_argument("--swap-tenor", type=float, default=5.0)
    p.add_argument("--bermudan", action="store_true",
                   help="also price the ATM Bermudan (first expiry, "
                        "semi-annual calls; x-grid PDE)")
    p.add_argument("--cap-vols", type=float, nargs="+", default=None,
                   help="flat Black cap vols: strip forward caplet vols, "
                        "price the strip, and fit (a, sigma) to it")
    p.add_argument("--cap-maturities", type=float, nargs="+",
                   default=[1.0, 2.0, 3.0, 5.0])
    p.add_argument("--cap-strike", type=float, default=None,
                   help="cap strike (default: ATM swap rate to the "
                        "longest maturity)")
    p.set_defaults(func=cmd_rates, config=None)

    p = sub.add_parser("credit", help="CDS bootstrap + swap CVA")
    p.add_argument("--curve-times", type=float, nargs="+",
                   default=[0.5, 1.0, 2.0, 5.0, 10.0, 30.0])
    p.add_argument("--curve-zeros", type=float, nargs="+",
                   default=[0.030, 0.032, 0.035, 0.040, 0.042, 0.043])
    p.add_argument("--pillars", type=float, nargs="+",
                   default=[1.0, 3.0, 5.0, 7.0, 10.0])
    p.add_argument("--spreads", type=float, nargs="+",
                   default=[0.008, 0.011, 0.013, 0.014, 0.015],
                   help="par CDS spreads (decimal, e.g. 0.01 = 100bp)")
    p.add_argument("--recovery", type=float, default=0.4)
    p.add_argument("--cva-tenor", type=float, default=5.0,
                   help="CVA of the ATM payer swap to this tenor "
                        "(0 disables)")
    p.add_argument("--a", type=float, default=0.1,
                   help="Hull-White mean reversion for the CVA exposure")
    p.add_argument("--sigma", type=float, default=0.012)
    p.set_defaults(func=cmd_credit, config=None)

    p = sub.add_parser("pide", help="jump-diffusion strip (Merton/Kou PIDE)")
    p.add_argument("--jumps", choices=["merton", "kou"], default="merton")
    p.add_argument("--strikes", type=float, nargs="+",
                   default=[80.0, 90.0, 100.0, 110.0, 120.0])
    p.add_argument("--spot", type=float, default=100.0)
    p.add_argument("--maturity", type=float, default=0.5)
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--dividend", type=float, default=0.0)
    p.add_argument("--vol", type=float, default=0.2, help="diffusive vol")
    p.add_argument("--lam", type=float, default=0.5, help="jump intensity")
    p.add_argument("--mu-j", dest="mu_j", type=float, default=-0.1)
    p.add_argument("--sigma-j", dest="sigma_j", type=float, default=0.15)
    p.add_argument("--p-up", dest="p_up", type=float, default=0.4,
                   help="kou up-jump probability")
    p.add_argument("--eta1", type=float, default=10.0)
    p.add_argument("--eta2", type=float, default=5.0)
    p.add_argument("--put", action="store_true")
    p.add_argument("--american", action="store_true")
    p.add_argument("--n-space", dest="n_space", type=int, default=512)
    p.add_argument("--n-time", dest="n_time", type=int, default=128)
    p.add_argument("--oracle-check", dest="oracle_check", action="store_true",
                   help="also report max abs error vs the float64 oracle")
    p.set_defaults(func=cmd_pide, config=None)

    p = sub.add_parser("fwdstart", help="forward-start vanillas / cliquet strip (forward smile)")
    p.add_argument("--rel-strikes", dest="rel_strikes", type=float, nargs="+",
                   default=[0.9, 1.0, 1.1])
    p.add_argument("--fixing", type=float, default=0.5)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--rate", type=float, default=0.0)
    p.add_argument("--dividend", type=float, default=0.0)
    p.add_argument("--put", action="store_true")
    p.add_argument("--mc-check", dest="mc_check", action="store_true",
                   help="also price through the QE MC route")
    p.add_argument("--cliquet-periods", dest="cliquet_periods", type=int, default=0)
    p.add_argument("--local-floor", dest="local_floor", type=float, default=0.0)
    p.add_argument("--local-cap", dest="local_cap", type=float, default=0.08)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--sigma", type=float, default=0.3)
    p.add_argument("--rho", type=float, default=-0.7)
    p.add_argument("--v0", type=float, default=0.04)
    p.set_defaults(func=cmd_fwdstart, config=None)

    p = sub.add_parser("status", help="system component status")
    p.set_defaults(func=cmd_status, config=None)

    p = sub.add_parser("config", help="show or save resolved config")
    p.add_argument("--save", default=None)
    p.set_defaults(func=cmd_config, config=None)

    p = sub.add_parser("demo", help="end-to-end calibrate -> signal -> backtest demo")
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(func=cmd_demo, config=None)

    p = sub.add_parser("portfolio", help="portfolio status")
    p.set_defaults(func=cmd_portfolio, config=None)

    p = common(sub.add_parser("scan", help="scan for mean-reversion candidates"))
    p.add_argument("--symbols", nargs="+", default=["SPY", "QQQ", "IWM", "TLT"])
    p.set_defaults(func=cmd_scan)

    p = common(sub.add_parser("sector-portfolio", help="confidence-weighted sector book"))
    p.add_argument("--symbols", nargs="+", default=["AAPL", "JPM", "XOM", "SPY"])
    p.add_argument("--capital", type=float, default=1_000_000.0)
    p.set_defaults(func=cmd_sector_portfolio)

    p = common(sub.add_parser("rolling-backtest", help="optimize window N, trade N+1"))
    p.add_argument("--symbol", default="SPY")
    p.add_argument("--opt-window", type=int, default=252, dest="opt_window")
    p.add_argument("--trade-window", type=int, default=63, dest="trade_window")
    p.add_argument("--strategies", nargs="*", default=None)
    p.set_defaults(func=cmd_rolling_backtest)

    p = common(sub.add_parser("optimize-sectors", help="per-sector strategy fitness search"))
    p.add_argument("--symbols", nargs="+", default=["AAPL", "MSFT", "JPM", "XOM"])
    p.add_argument("--cache", default=None)
    p.set_defaults(func=cmd_optimize_sectors)

    p = sub.add_parser("serve", help="run the micro-batching pricing service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--max-wait-ms", type=float, default=2.0, dest="max_wait_ms")
    p.set_defaults(func=cmd_serve, config=None)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from .utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    try:
        return args.func(args)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130


if __name__ == "__main__":
    sys.exit(main())
