"""Heston surface calibration — two-stage (DE global + LM local).

Mirrors the reference HestonCalibrator
(calibration/heston_calibrator.py:247-735) in API and semantics — same
bounds, same sum-of-squared-relative-errors objective (:486-513), same
relative-error residuals for the local stage (:515-536), same fit-quality
metrics (:588-643), Feller/bounds warnings (:645-674), cached-parameter
fallback and warm starts — but the compute is one jitted program:

* Stage 1 (global): :mod:`pde_tpu.calibrate.de` evaluates every DE
  generation as a single batched pricing tensor.  Where the reference runs
  ~7.7e7 scalar characteristic-function evaluations through a Python->C++
  per-option loop (SURVEY.md section 3.1), here the (popsize*5, n_options,
  n_quadrature) tensor is fused by XLA.
* Stage 2 (local): :mod:`pde_tpu.calibrate.lm` with jacfwd Jacobians.

``calibrate_batch`` vmaps the full two-stage pipeline over many underlyings
at once; shard its batch axis over a device mesh for multi-chip scaling.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import black_scholes as bs
from ..models import heston as heston_model
from ..models.heston import HestonParams
from .de import differential_evolution
from .lm import levenberg_marquardt

__all__ = ["CalibrationError", "CalibrationResult", "HestonCalibrator",
           "parameter_sensitivities"]

PARAM_ORDER = ("kappa", "theta", "sigma", "rho", "v0")


class CalibrationError(Exception):
    """Raised when calibration fails (reference heston_calibrator.py:40)."""


@dataclass
class CalibrationResult:
    """Calibration output (mirrors reference heston_calibrator.py:132-176)."""

    params: HestonParams
    fit_quality: Dict[str, float]
    convergence: Dict[str, Any]
    timestamp: datetime
    warnings: List[str] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return bool(
            self.convergence.get("local_converged", False)
            or self.convergence.get("cached", False)
        )

    @property
    def rmse(self) -> float:
        return float(self.fit_quality.get("rmse", float("inf")))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "params": {k: float(getattr(self.params, k)) for k in PARAM_ORDER},
            "fit_quality": self.fit_quality,
            "convergence": self.convergence,
            "timestamp": self.timestamp,
            "warnings": self.warnings,
            "success": self.success,
            "rmse": self.rmse,
        }


# Euler-Maclaurin-corrected Gauss-Legendre: reproduces the REFERENCE
# rectangle sum (not just the truncated integral) to ~1e-9 at price level
# from 70 instead of 1023 integrand evaluations
# (models/heston.py:_gl_ref_rule).  Both stages price through this rule, so
# DE and LM optimize numerically the SAME objective — the reference's.
# (History: round 1 coarsened the trapezoid to 256 x 0.04, which INVERTED
# the landscape — the true parameters scored 60x worse than a spurious
# sigma-at-bound basin; plain GL-64 then matched the ranking to ~1e-3
# relative but still carried the 0.16-absolute dropped-endpoint offset vs
# the reference sum.  The corrected rule removes that offset too.)
_DE_GL_POINTS = 64


# Grouped-CF pricing: the pipeline prices through these.  The characteristic
# function depends on (params, u, T) only, so a surface with M maturities
# and N >> M quotes pays M x n_u CF evaluations instead of N x n_u — the
# CF is ~10x the flops of the per-strike phase, so this is a several-fold
# cut in the DE/LM hot loop (models/heston.py: price_*_grouped).

def _price_vec_grouped(params_array, strikes, t_idx, unique_T, is_calls,
                       S0, r, q, n_points=heston_model.N_QUADRATURE,
                       du=heston_model.DU):
    p = HestonParams(*[params_array[i] for i in range(5)])
    return heston_model.price_carr_madan_grouped(
        p, strikes, t_idx, unique_T, S0, r, q, is_calls,
        n_points=n_points, du=du,
    )


def _price_vec_gl_grouped(params_array, strikes, t_idx, unique_T, is_calls,
                          S0, r, q, n_points=_DE_GL_POINTS):
    p = HestonParams(*[params_array[i] for i in range(5)])
    return heston_model.price_carr_madan_gl_grouped(
        p, strikes, t_idx, unique_T, S0, r, q, is_calls, n_points=n_points
    )


def _objective_population_gl_grouped(pop, strikes, t_idx, unique_T, is_calls,
                                     market_prices, mask, S0, r, q,
                                     n_points=_DE_GL_POINTS):
    """DE-stage objective: sum of squared relative errors per population
    member (reference heston_calibrator.py:486-513), priced on the
    corrected-GL grid with grouped CF evaluation.  ``mask`` zeroes the
    residuals of padded quote slots (shape-stable calibration, see
    _calibrate_pipeline).

    DEVIATION: the reference returns a flat 1e10 whenever ANY model price is
    non-positive (:507-508).  Its f64 1024-point quadrature rarely produces
    one; an f32 coarse-quadrature DE stage routinely does on deep-OTM
    short-dated quotes — even at the TRUE parameters — and the flat flag
    then turns the whole objective into a 1e10 plateau with zero search
    signal.  Instead non-positive prices are clamped to 1e-10 (exactly what
    the reference's OWN local-stage residuals do, :533), which charges ~1.0
    squared relative error per bad quote and keeps the landscape
    informative.  NaN still gets the hard penalty."""
    prices = jax.vmap(
        lambda x: _price_vec_gl_grouped(
            x, strikes, t_idx, unique_T, is_calls, S0, r, q, n_points
        )
    )(pop)
    # neutralize padded slots BEFORE the NaN check: NaN * 0 is NaN, so a
    # non-finite price in a mask=0 slot must not hard-penalize the member
    prices = jnp.where(mask > 0, prices, market_prices)
    nan_bad = jnp.any(jnp.isnan(prices), axis=-1)
    prices = jnp.maximum(prices, 1e-10)
    errors = mask * (prices - market_prices) / market_prices
    obj = jnp.sum(errors * errors, axis=-1)
    return jnp.where(nan_bad, 1e10, obj)


@partial(
    jax.jit,
    static_argnames=("global_maxiter", "global_popsize", "local_max_iter"),
)
def _calibrate_pipeline(
    strikes,
    t_idx,
    unique_T,
    is_calls,
    market_prices,
    mask,
    S0,
    r,
    q,
    lower,
    upper,
    key,
    x0,
    use_x0,
    global_maxiter: int = 100,
    global_popsize: int = 15,
    local_max_iter: int = 60,
):
    """The full two-stage calibration as one jitted program.

    Maturities arrive pre-grouped as ``(t_idx, unique_T)`` from
    :func:`pde_tpu.models.heston.group_maturities` so every pricing call
    shares CF evaluations across the strikes of each maturity.

    ``mask`` (same shape as ``strikes``, 1.0 = real quote, 0.0 = padding)
    weights every residual, which makes the compiled program reusable
    across chains of different sizes: the caller pads the quote axis to a
    shape bucket and masks the tail.  Padded slots contribute zero to the
    DE objective, zero rows to the LM Jacobian, and nothing to
    convergence."""

    def objective(pop):
        return _objective_population_gl_grouped(
            pop, strikes, t_idx, unique_T, is_calls, market_prices, mask,
            S0, r, q,
        )

    # warm start seeds the DE population (heston_calibrator.py:411-413)
    seed = jnp.where(use_x0, x0, 0.5 * (lower + upper))
    de = differential_evolution(
        objective,
        lower,
        upper,
        key,
        x0=seed,
        popsize=global_popsize,
        maxiter=global_maxiter,
        # floor-immune early termination (see calibrate/de.py): stop when
        # the population collapses below 1% of the box per dimension, when
        # the best energy stalls for 12 generations, OR when the best
        # member reaches basin-capture quality — 1e-4 mean squared relative
        # price error per quote = 1% mean price error, comfortably inside
        # the multistart LM's capture basin.  The LM stage recovers
        # identical parameters either way (regression-tested in
        # tests/test_calibrate.py) at measurably lower wall-clock
        # (generation count ~4x down on the flagship surface).
        param_tol=1e-2,
        stagnation_patience=12,
        target_energy=1e-4 * jnp.sum(mask),
    )

    def residuals(x):
        # corrected-GL pricer: numerically the reference objective (~1e-9
        # price agreement) at 15x fewer quadrature points per LM iteration
        prices = _price_vec_gl_grouped(x, strikes, t_idx, unique_T, is_calls, S0, r, q)
        # padded slots must yield an EXACT zero residual even when the CF
        # NaNs there (mask * NaN = NaN would poison the cost and Jacobian)
        prices = jnp.where(mask > 0, prices, market_prices)
        prices = jnp.maximum(prices, 1e-10)  # heston_calibrator.py:533
        return mask * (prices - market_prices) / market_prices

    # MULTISTART local stage (deviation from the reference's single
    # least_squares from the DE best, :469-477): polish the top-k DE members
    # in one vmapped LM and keep the lowest-cost fit.  The DE best under the
    # basin-level objective is sometimes a spurious local minimum of the
    # full objective; k independent descents cost ~k extra LM runs (cheap
    # next to the DE stage) and measurably de-flake parameter recovery.
    k_starts = min(4, global_popsize * 5)
    order = jnp.argsort(de.population_energies)
    starts = de.population[order[:k_starts]]

    # INFORMED START (identification heuristic): under Heston, short-maturity
    # ATM implied variance ~ v0 and long-maturity ATM implied variance ~ the
    # level the variance reverts to (theta).  A tiny DE budget on a weakly
    # identified surface (few maturities) can put ALL top-k members in one
    # spurious basin (observed: v0 off by 0.016 at cost 3e-5 with
    # maxiter=30, popsize=8 — a genuine local minimum, bound-hugging kappa
    # and sigma); one deterministic data-driven start makes the multistart
    # robust to that independently of the DE draw.
    T_q = unique_T[t_idx]
    fdtype = strikes.dtype
    big = jnp.asarray(1e18, fdtype)
    fwd = S0 * jnp.exp((r - q) * T_q)
    # a rough vol level is enough to seed the start — 8 Newton iterations,
    # not the solver's default 100 (ATM quotes converge in ~5)
    iv = bs.implied_vol(market_prices, S0, strikes, r, q, T_q, is_calls,
                        max_iter=8)
    atm_pen = jnp.abs(strikes - fwd) + (1.0 - mask) * big
    t_short = jnp.min(jnp.where(mask > 0, T_q, big))
    t_long = jnp.max(jnp.where(mask > 0, T_q, -big))
    i_short = jnp.argmin(atm_pen + big * (T_q != t_short))
    i_long = jnp.argmin(atm_pen + big * (T_q != t_long))
    informed = jnp.stack([
        jnp.clip(jnp.asarray(2.0, fdtype), lower[0], upper[0]),
        jnp.clip(iv[i_long] ** 2, lower[1], upper[1]),
        jnp.clip(jnp.asarray(0.5, fdtype), lower[2], upper[2]),
        jnp.clip(jnp.asarray(-0.5, fdtype), lower[3], upper[3]),
        jnp.clip(iv[i_short] ** 2, lower[4], upper[4]),
    ])
    informed = jnp.where(jnp.isfinite(informed), informed, 0.5 * (lower + upper))
    starts = jnp.concatenate([starts, informed[None, :]], axis=0)

    def polish(x0):
        # two chained LM passes with a FRESH damping state: long descents
        # through ill-conditioned territory (the kappa-sigma ridge) inflate
        # lambda via rejected steps, strangling progress; restarting from
        # the first pass's iterate with lam reset to lam0 reaches the
        # optimum in a handful of further iterations (measured: stuck at
        # cost 2.6e-4 after 60 iters -> 1.4e-26 thirteen iterations after
        # the restart).
        first = levenberg_marquardt(
            residuals, x0, lower, upper, max_iter=local_max_iter, ftol=1e-8
        )
        return levenberg_marquardt(
            residuals, first.x, lower, upper, max_iter=local_max_iter, ftol=1e-8
        )

    lm_all = jax.vmap(polish)(starts)
    best = jnp.argmin(lm_all.cost)
    lm_x = lm_all.x[best]
    lm = type(lm_all)(
        x=lm_x, cost=lm_all.cost[best], n_iter=lm_all.n_iter[best],
        converged=lm_all.converged[best], grad_norm=lm_all.grad_norm[best],
    )

    # final reported prices/fit quality stay on the LITERAL reference grid
    # (price_carr_madan_grouped) so stored RMSE/R2 keep exact reference
    # semantics; only the optimizer hot loops use the corrected-GL rule
    model_prices = _price_vec_grouped(lm.x, strikes, t_idx, unique_T, is_calls, S0, r, q)
    return (de.x, de.fun, de.n_iter, lm.x, lm.cost, lm.converged, lm.n_iter,
            model_prices)


@jax.jit
def _sensitivities_impl(x, strikes, t_idx, unique_T, is_calls, market_prices,
                        mask, S0, r, q):
    """d(calibrated params)/d(market prices) at the LM optimum, via the
    implicit function theorem on the Gauss-Newton normal equations.

    Residuals are the pipeline's relative errors r_i = m_i(x)/p_i - 1, so
    the stationarity condition J^T r = 0 differentiates to

        dx*/dp = -(J^T J)^{-1} J^T  diag(dr/dp),   dr_i/dp_i = -m_i / p_i^2.

    Exact AD Jacobian through the grouped Carr-Madan pricer (the same
    forward tangents the LM stage uses).  The reference has no analogue:
    its scipy pipeline exposes no quote-level sensitivities at all.
    """

    def model(xv):
        # same pricer as the LM residuals so the IFT linearization matches
        # the stationarity condition the optimum actually satisfies
        return jnp.maximum(
            _price_vec_gl_grouped(xv, strikes, t_idx, unique_T, is_calls, S0, r, q),
            1e-10,
        )

    m = model(x)
    Jm = jax.jacfwd(model)(x)                        # (N, 5) dm/dx
    w = mask / market_prices
    J = Jm * w[:, None]                              # (N, 5) dr/dx
    # HIGHEST: a GPU may run a default-precision f32 matmul in TF32 (about
    # three decimal digits) — too coarse for ill-conditioned normal
    # equations (see calibrate/lm.py)
    JTJ = jnp.matmul(J.T, J, precision=jax.lax.Precision.HIGHEST)
    drdp = -mask * m / (market_prices ** 2)          # (N,) dr_i/dp_i
    rhs = J.T * drdp[None, :]                        # (5, N)
    ridge = 1e-12 * jnp.trace(JTJ) * jnp.eye(5, dtype=JTJ.dtype)
    dxdp = -jnp.linalg.solve(JTJ + ridge, rhs)       # (5, N)
    return dxdp, m, JTJ


def parameter_sensitivities(params, strikes, maturities, is_calls,
                            market_prices, S0, r, q=0.0,
                            quote_noise_rel: float = 0.0):
    """Quote-level sensitivities of a calibrated parameter set.

    Returns a dict with

    * ``dparams_dprice`` — (5, N): first-order response of
      (kappa, theta, sigma, rho, v0) to a unit bump of each market price;
    * ``influence`` — (N,): L2 norm of each quote's parameter response
      scaled by 1% of its price (which quotes move the calibration);
    * ``param_cov`` / ``param_std`` — Gauss-Newton parameter covariance for
      i.i.d. relative price noise ``quote_noise_rel`` (omitted when 0).

    Use cases the reference cannot serve: quote-level hedging of parameter
    risk, bad-quote detection (outsized influence), and daily parameter
    error bars.  jit-compiled; ``vmap`` over params/surfaces for books.
    """
    strikes = np.asarray(strikes, dtype=np.float64)
    unique_T, t_idx = heston_model.group_maturities(maturities)
    x = jnp.asarray([params.kappa, params.theta, params.sigma,
                     params.rho, params.v0])
    dxdp, model_prices, JTJ = _sensitivities_impl(
        x, jnp.asarray(strikes), jnp.asarray(t_idx), jnp.asarray(unique_T),
        jnp.asarray(np.asarray(is_calls, dtype=bool)),
        jnp.asarray(np.asarray(market_prices, dtype=np.float64)),
        jnp.ones(len(strikes)), S0, r, q,
    )
    dxdp, model_prices, JTJ = jax.device_get((dxdp, model_prices, JTJ))
    out = {
        "dparams_dprice": np.asarray(dxdp),
        "model_prices": np.asarray(model_prices),
        "influence": np.linalg.norm(
            np.asarray(dxdp) * 0.01 * np.asarray(market_prices)[None, :], axis=0
        ),
    }
    if quote_noise_rel > 0.0:
        sig = quote_noise_rel * np.asarray(market_prices)
        cov = (np.asarray(dxdp) * sig[None, :] ** 2) @ np.asarray(dxdp).T
        out["param_cov"] = cov
        out["param_std"] = np.sqrt(np.maximum(np.diag(cov), 0.0))
    return out


class HestonCalibrator:
    """Two-stage Heston calibrator (API parity with the reference class).

    Args mirror heston_calibrator.py:209-234; ``db`` is any object exposing
    ``store_model_parameters``/``get_latest_model_parameters`` (the
    pde_tpu.database.ParameterStore qualifies).
    """

    DEFAULT_BOUNDS = {
        "kappa": (0.1, 10.0),
        "theta": (0.01, 1.0),
        "sigma": (0.01, 2.0),
        "rho": (-0.99, 0.99),
        "v0": (0.01, 1.0),
    }

    def __init__(
        self,
        db=None,
        bounds: Optional[Dict[str, Tuple[float, float]]] = None,
        global_maxiter: int = 100,
        global_popsize: int = 15,
        local_max_iter: int = 60,
        seed: int = 42,
        pad_shapes: bool = True,
    ):
        self.db = db
        self.bounds = bounds or dict(self.DEFAULT_BOUNDS)
        self.global_maxiter = global_maxiter
        self.global_popsize = global_popsize
        self.local_max_iter = local_max_iter
        self.seed = seed
        # pad the quote/maturity axes up to shape buckets so day-to-day
        # chain-size changes reuse one compiled pipeline (each new
        # (n_quotes, n_maturities) shape otherwise pays a multi-second XLA
        # compile - a device-production concern the CPU reference never had)
        self.pad_shapes = pad_shapes

    # ------------------------------------------------------------------ API

    def calibrate(
        self,
        market_options,
        S0: float,
        r: float,
        q: float,
        warm_start: Optional[Dict[str, float]] = None,
        use_cached_on_failure: bool = True,
        underlying: Optional[str] = None,
    ) -> CalibrationResult:
        """Calibrate to market option prices.

        ``market_options``: DataFrame or dict with columns/keys
        'strike', 'maturity', 'mid_price' and optionally 'is_call' /
        'option_type' / 'underlying' (same schema as the reference).
        """
        start = time.time()
        strikes, maturities, prices, is_calls, underlying = self._extract(
            market_options, underlying
        )

        try:
            lower = jnp.array([self.bounds[k][0] for k in PARAM_ORDER])
            upper = jnp.array([self.bounds[k][1] for k in PARAM_ORDER])
            if warm_start:
                x0 = jnp.array([warm_start[k] for k in PARAM_ORDER])
                use_x0 = jnp.asarray(True)
            else:
                x0 = jnp.zeros(5)
                use_x0 = jnp.asarray(False)

            key = jax.random.PRNGKey(self.seed)
            n_real = len(strikes)
            if self.pad_shapes:
                n_pad = max(32, -(-n_real // 32) * 32)  # next multiple of 32
                # maturity buckets of 2: the CF cost scales with M, so keep
                # padding tight (quote counts move day to day far more than
                # maturity counts)
                unique_T, t_idx = heston_model.group_maturities(
                    maturities,
                    pad_to=-(-len(np.unique(maturities)) // 2) * 2,
                )
                pad = n_pad - n_real
                strikes_p = np.concatenate([strikes, np.full(pad, float(S0))])
                t_idx = np.concatenate([t_idx, np.zeros(pad, t_idx.dtype)])
                is_calls_p = np.concatenate([is_calls, np.ones(pad, bool)])
                prices_p = np.concatenate([prices, np.ones(pad)])
                mask = np.concatenate([np.ones(n_real), np.zeros(pad)])
            else:
                unique_T, t_idx = heston_model.group_maturities(maturities)
                strikes_p, is_calls_p, prices_p = strikes, is_calls, prices
                mask = np.ones(n_real)
            (de_x, de_fun, de_iter, lm_x, lm_cost, lm_conv, lm_iter,
             model_prices) = (
                _calibrate_pipeline(
                    jnp.asarray(strikes_p),
                    jnp.asarray(t_idx),
                    jnp.asarray(unique_T),
                    jnp.asarray(is_calls_p),
                    jnp.asarray(prices_p),
                    jnp.asarray(mask),
                    S0,
                    r,
                    q,
                    lower,
                    upper,
                    key,
                    x0,
                    use_x0,
                    global_maxiter=self.global_maxiter,
                    global_popsize=self.global_popsize,
                    local_max_iter=self.local_max_iter,
                )
            )

            # ONE batched device->host transfer instead of one
            # float()/np.asarray() synchronization per output
            (de_fun, de_iter, lm_x, lm_cost, lm_conv, lm_iter,
             model_prices) = jax.device_get(
                (de_fun, de_iter, lm_x, lm_cost, lm_conv, lm_iter,
                 model_prices)
            )
            params = HestonParams(*[float(v) for v in lm_x])
            warnings = self._validate_parameters(
                params, max_maturity=float(np.max(maturities))
            )
            model_prices = np.asarray(model_prices)[:n_real]
            fit_quality = self._fit_quality(model_prices, prices, params)
            elapsed_ms = int((time.time() - start) * 1000)

            result = CalibrationResult(
                params=params,
                fit_quality=fit_quality,
                convergence={
                    "global_converged": True,
                    "local_converged": bool(lm_conv),
                    "global_nit": int(de_iter),
                    "local_nfev": int(lm_iter),
                    "global_obj": float(de_fun),
                    "local_cost": float(lm_cost),
                    "calibration_time_ms": elapsed_ms,
                },
                timestamp=datetime.now(),
                warnings=warnings,
            )
            if self.db is not None:
                self._store(result, underlying)
            return result

        except Exception as exc:  # noqa: BLE001 - mirror reference fallback
            if use_cached_on_failure and self.db is not None:
                cached = self._load_cached(underlying)
                if cached is not None:
                    return cached
            raise CalibrationError(f"Calibration failed: {exc}") from exc

    def calibrate_batch(
        self,
        strikes: np.ndarray,
        maturities: np.ndarray,
        market_prices: np.ndarray,
        S0: np.ndarray,
        r: float,
        q: float,
        is_calls: Optional[np.ndarray] = None,
        mesh=None,
    ):
        """Calibrate MANY surfaces at once: all inputs carry a leading
        underlyings axis (U, n_options) / (U,).  Returns batched parameter
        arrays.

        This is the multi-device path (reference scale-out analog:
        calibration service replicas, SURVEY.md §2.3).  Pass a 2D
        ``jax.sharding.Mesh`` with axes ("dp", "quotes") and the FULL
        two-stage pipeline — DE generations, LM trust-region loop,
        convergence logic — runs under explicit NamedShardings: U over
        ``dp`` (embarrassingly parallel), the quote axis over ``quotes``
        (objective sums and J^T J / J^T r contractions become XLA
        all-reduces between devices).  n_options must divide by the quotes size;
        when U does not divide by the dp size the batch is padded with
        copies of the last surface (results sliced back to U).
        """
        U = strikes.shape[0]
        if is_calls is None:
            is_calls = np.ones_like(strikes, dtype=bool)
        pad_u = 0
        if mesh is not None and "dp" in mesh.shape:
            dp_size = mesh.shape["dp"]
            pad_u = (-U) % dp_size
            if pad_u:
                def _pad(a):
                    a = np.asarray(a)
                    reps = (pad_u,) + (1,) * (a.ndim - 1)
                    return np.concatenate([a, np.tile(a[-1:], reps)])
                strikes, maturities, market_prices, S0, is_calls = (
                    _pad(a) for a in
                    (strikes, maturities, market_prices, S0, is_calls)
                )
        lower = jnp.array([self.bounds[k][0] for k in PARAM_ORDER])
        upper = jnp.array([self.bounds[k][1] for k in PARAM_ORDER])
        keys = jax.random.split(jax.random.PRNGKey(self.seed), U + pad_u)

        # per-surface maturity grouping, padded to a common static M so the
        # batch vmaps (padded CF rows are priced by no option)
        grouped = [heston_model.group_maturities(m) for m in np.asarray(maturities)]
        max_m = max(len(uT) for uT, _ in grouped)
        unique_T = np.stack([
            np.concatenate([uT, np.full(max_m - len(uT), uT[-1])])
            for uT, _ in grouped
        ])
        t_idx = np.stack([idx for _, idx in grouped])

        def one(args):
            k_, s_, ti_, ut_, c_, p_, w_, spot_ = args
            return _calibrate_pipeline(
                s_, ti_, ut_, c_, p_, w_, spot_, r, q, lower, upper, k_,
                jnp.zeros(5), jnp.asarray(False),
                global_maxiter=self.global_maxiter,
                global_popsize=self.global_popsize,
                local_max_iter=self.local_max_iter,
            )

        batched = jax.vmap(one)
        args = (
            keys,
            jnp.asarray(strikes),
            jnp.asarray(t_idx),
            jnp.asarray(unique_T),
            jnp.asarray(is_calls),
            jnp.asarray(market_prices),
            jnp.ones_like(jnp.asarray(strikes)),
            jnp.asarray(S0),
        )
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            dq = NamedSharding(mesh, P("dp", "quotes"))
            d1 = NamedSharding(mesh, P("dp"))
            batched = jax.jit(
                batched,
                in_shardings=((d1, dq, dq, d1, dq, dq, dq, d1),),
            )
            args = jax.device_put(args, (d1, dq, dq, d1, dq, dq, dq, d1))
        out = batched(args)
        de_x, de_fun, de_iter, lm_x, lm_cost, lm_conv, lm_iter, model_prices = out
        return {
            "params": lm_x[:U],
            "cost": lm_cost[:U],
            "converged": lm_conv[:U],
            "model_prices": model_prices[:U],
        }

    # ------------------------------------------------------------ internals

    @staticmethod
    def _extract(market_options, underlying):
        if hasattr(market_options, "columns"):  # DataFrame
            cols = market_options.columns
            for col in ("strike", "maturity", "mid_price"):
                if col not in cols:
                    raise ValueError(f"Missing required column: {col}")
            strikes = market_options["strike"].to_numpy(dtype=np.float64)
            maturities = market_options["maturity"].to_numpy(dtype=np.float64)
            prices = market_options["mid_price"].to_numpy(dtype=np.float64)
            if "is_call" in cols:
                is_calls = market_options["is_call"].to_numpy(dtype=bool)
            elif "option_type" in cols:
                is_calls = (
                    market_options["option_type"].str.lower() == "call"
                ).to_numpy()
            else:
                is_calls = np.ones(len(strikes), dtype=bool)
            if underlying is None:
                underlying = (
                    str(market_options["underlying"].iloc[0])
                    if "underlying" in cols
                    else "UNKNOWN"
                )
        else:  # dict of arrays
            for colname in ("strike", "maturity", "mid_price"):
                if colname not in market_options:
                    raise ValueError(f"Missing required column: {colname}")
            strikes = np.asarray(market_options["strike"], dtype=np.float64)
            maturities = np.asarray(market_options["maturity"], dtype=np.float64)
            prices = np.asarray(market_options["mid_price"], dtype=np.float64)
            # same schema as the DataFrame branch: honor option_type too
            if "is_call" in market_options:
                is_calls = np.asarray(market_options["is_call"], dtype=bool)
            elif "option_type" in market_options:
                is_calls = np.asarray(
                    [str(t).lower() == "call"
                     for t in np.atleast_1d(market_options["option_type"])]
                )
            else:
                is_calls = np.ones(len(strikes), dtype=bool)
            if underlying is None and "underlying" in market_options:
                underlying = str(np.atleast_1d(market_options["underlying"])[0])
            underlying = underlying or "UNKNOWN"

        # input validation (heston_calibrator.py:676-698)
        if np.any(prices <= 0):
            raise ValueError(f"Found {int(np.sum(prices <= 0))} options with price <= 0")
        if np.any(maturities <= 0):
            raise ValueError(
                f"Found {int(np.sum(maturities <= 0))} options with maturity <= 0"
            )
        return strikes, maturities, prices, is_calls, underlying

    @staticmethod
    def _fit_quality(model_prices, market_prices, params: HestonParams):
        """RMSE / R^2 / relative and absolute errors (heston_calibrator.py:588-643)."""
        errors = model_prices - market_prices
        rmse = float(np.sqrt(np.mean(errors**2)))
        ss_res = float(np.sum(errors**2))
        ss_tot = float(np.sum((market_prices - np.mean(market_prices)) ** 2))
        return {
            "rmse": rmse,
            "r_squared": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
            "relative_rmse": rmse / float(np.mean(market_prices)),
            "max_abs_error": float(np.max(np.abs(errors))),
            "mean_abs_error": float(np.mean(np.abs(errors))),
            "n_options": int(len(market_prices)),
            "feller_satisfied": bool(params.feller_satisfied()),
            "feller_value": float(params.feller_value()),
        }

    @staticmethod
    def _validate_parameters(params: HestonParams,
                             max_maturity: float | None = None) -> List[str]:
        """Warning heuristics matching heston_calibrator.py:645-674, plus a
        Carr-Madan validity check the reference lacks (see
        models/heston.py:moment_explosion_time)."""
        warnings = []
        k, t, s, rho, v0 = (float(getattr(params, n)) for n in PARAM_ORDER)
        if not params.feller_satisfied():
            warnings.append(
                f"Feller condition violated: 2kappa*theta = {2*k*t:.4f} < "
                f"sigma^2 = {s**2:.4f}. Variance may reach zero."
            )
        if max_maturity is not None:
            t_star = heston_model.moment_explosion_time(
                params, 1.0 + heston_model.INTEGRATION_ALPHA
            )
            if max_maturity >= 0.8 * t_star:
                warnings.append(
                    f"Carr-Madan validity at risk: the 1.75-moment explosion "
                    f"time T*={t_star:.2f} is within 25% of the longest "
                    f"quoted maturity {max_maturity:.2f}; quadrature prices "
                    f"near that horizon are unreliable at these parameters."
                )
        if k > 8.0:
            warnings.append(f"Very high mean-reversion speed: kappa={k:.2f}")
        if s > 1.5:
            warnings.append(f"Very high vol of vol: sigma={s:.2f}")
        if abs(rho) > 0.95:
            warnings.append(f"Extreme correlation: rho={rho:.2f}")
        if v0 > 0.5:
            warnings.append(f"Very high initial variance: v0={v0:.2f}")
        return warnings

    def _store(self, result: CalibrationResult, underlying: str):
        self.db.store_model_parameters(
            model_type="heston",
            underlying=underlying,
            parameters={k: float(getattr(result.params, k)) for k in PARAM_ORDER},
            fit_quality=result.fit_quality,
            maturity=None,
            converged=result.convergence["local_converged"],
            calibration_time_ms=result.convergence["calibration_time_ms"],
        )

    def _load_cached(self, underlying: str) -> Optional[CalibrationResult]:
        cached = self.db.get_latest_model_parameters(
            model_type="heston", underlying=underlying, maturity=None
        )
        if cached and cached.get("converged", False):
            return CalibrationResult(
                params=HestonParams(**{k: cached["parameters"][k] for k in PARAM_ORDER}),
                fit_quality=cached["fit_quality"],
                convergence={"cached": True},
                timestamp=cached["time"],
                warnings=["Using cached parameters"],
            )
        return None

    # ------------------------------------------------------------- fixtures

    @classmethod
    def generate_synthetic_data(
        cls,
        S0: float = 100.0,
        r: float = 0.05,
        q: float = 0.02,
        kappa: float = 2.0,
        theta: float = 0.04,
        sigma: float = 0.3,
        rho: float = -0.7,
        v0: float = 0.04,
        n_strikes: int = 11,
        n_maturities: int = 3,
        noise_std: float = 0.0,
        strikes: Optional[np.ndarray] = None,
        maturities: Optional[np.ndarray] = None,
        seed: int = 0,
        as_dataframe: bool = False,
    ):
        """Synthetic surface from known parameters (heston_calibrator.py:736-816)."""
        if strikes is None:
            strikes = np.linspace(0.8 * S0, 1.2 * S0, n_strikes)
        if maturities is None:
            maturities = np.linspace(0.1, 1.0, n_maturities)

        K, T = np.meshgrid(strikes, maturities)
        K, T = K.ravel(), T.ravel()
        params = HestonParams(kappa=kappa, theta=theta, sigma=sigma, rho=rho, v0=v0)
        # jit the pricing call: one compiled program for the complex
        # characteristic-function graph instead of op-by-op dispatch
        priced = jax.jit(heston_model.price_options)(
            params, jnp.asarray(K), jnp.asarray(T), S0, r, q
        )
        prices = np.asarray(priced)
        # DROP sub-penny quotes instead of flooring them.  The reference
        # passes raw f64 model prices (heston_calibrator.py:790-797) so its
        # round-trip is self-consistent; this build's f32 pricing can go
        # epsilon-negative on deep-OTM short-dated quotes, and a 0.01 FLOOR
        # (the round-1 behavior) fabricates ~4000%-IV quotes that a
        # fat-tailed parameter set fits BETTER than the truth — the
        # objective then legitimately prefers a spurious basin.  No real
        # chain quotes those mids; drop them, as the reference's own
        # orchestrator liquidity filter would.
        keep = prices >= 0.01
        K, T, prices = K[keep], T[keep], prices[keep]
        if noise_std > 0:
            rng = np.random.default_rng(seed)
            prices = np.maximum(prices * (1 + rng.normal(0, noise_std, len(prices))), 0.01)

        data = {
            "strike": K,
            "maturity": T,
            "mid_price": prices,
            "is_call": np.ones(len(K), dtype=bool),
        }
        if as_dataframe:
            import pandas as pd

            df = pd.DataFrame(data)
            df["option_type"] = "call"
            df["underlying"] = "SYNTHETIC"
            return df
        return data

    generate_synthetic_options = generate_synthetic_data
