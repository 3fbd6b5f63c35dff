"""Rough Heston surface calibration.

Fits (hurst, lam, theta, nu, rho, v0) to an option surface with the same
in-house bounded Levenberg-Marquardt the classic calibrator uses
(calibrate/lm.py) — the pricer (models/rough_heston.price_rough) is a pure
jittable function, so the Jacobian comes from ``jax.jacfwd`` straight
through the fractional-Riccati scan.  The whole fit is ONE jitted XLA
program per surface shape.

Identification note: a single smile cannot separate H from nu (both steepen
the short end); the fitter wants >= 2 maturities, ideally including a short
one where the T^{H-1/2} skew term dominates.  ``fit_quality`` mirrors the
classic calibrator's RMSE/max-error report
(reference: calibration/heston_calibrator.py:588).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..models.rough_heston import RoughHestonParams, price_rough
from .lm import levenberg_marquardt

__all__ = ["RoughHestonCalibrator", "RoughCalibrationResult"]

# (hurst, lam, theta, nu, rho, v0)
_LOWER = np.array([0.02, 0.1, 0.005, 0.05, -0.95, 0.005])
_UPPER = np.array([0.5, 10.0, 1.0, 2.0, 0.0, 1.0])


@dataclass
class RoughCalibrationResult:
    params: RoughHestonParams
    rmse: float
    converged: bool
    n_iter: int
    fit_quality: Dict[str, float] = field(default_factory=dict)


def _best_of_starts(residuals, x0s, lower, upper, max_iter):
    """Multistart LM: run the same bounded LM from every row of ``x0s`` and
    keep the lowest-cost run.  The float32 device path needs this — a single
    LM can stall in a bad damping cycle from an unlucky start (observed:
    the same start that reaches 1e-3 on CPU-f32 plateaued at 5e-2 on the
    chip), and the classic calibrator's pipeline is multistart for the
    same reason."""
    run = jax.vmap(
        lambda s: levenberg_marquardt(residuals, s, lower, upper,
                                      max_iter=max_iter)
    )
    res = run(x0s)
    i = jnp.argmin(res.cost)
    return jax.tree_util.tree_map(lambda a: a[i], res)


@functools.partial(jax.jit, static_argnames=("n_steps", "max_iter"))
def _fit(strikes, maturities, mids, S0, r, q, x0s, lower, upper,
         n_steps: int, max_iter: int):
    """strikes/mids: (n_mat, n_k); maturities: (n_mat,); x0s: (k, 6)."""

    def residuals(x):
        p = RoughHestonParams(x[0], x[1], x[2], x[3], x[4], x[5])

        def smile(args):
            k_row, T = args
            return price_rough(p, k_row, T, S0, r, q, n_steps=n_steps)

        model = jax.lax.map(smile, (strikes, maturities))
        return ((model - mids) / jnp.maximum(mids, 1e-8)).ravel()

    return _best_of_starts(residuals, x0s, lower, upper, max_iter)


@functools.partial(jax.jit, static_argnames=("n_steps", "max_iter"))
def _fit_flat(strikes, t_idx, unique_T, is_call, mids, S0, r, q,
              x0, lower, upper, n_steps: int, max_iter: int):
    """Flat quote-vector fit (the classic calibrator's input convention):
    strikes/mids/is_call (n_quotes,), t_idx maps each quote to its row in
    unique_T.  Each unique maturity prices the WHOLE strike vector once
    (the Riccati solve is per-maturity, shared across strikes), then each
    quote selects its own maturity row."""

    def residuals(x):
        p = RoughHestonParams(x[0], x[1], x[2], x[3], x[4], x[5])

        def per_t(T):
            return price_rough(p, strikes, T, S0, r, q,
                               is_call=is_call, n_steps=n_steps)

        grid = jax.lax.map(per_t, unique_T)          # (n_T, n_quotes)
        model = jnp.take_along_axis(grid, t_idx[None, :], axis=0)[0]
        return (model - mids) / jnp.maximum(mids, 1e-8)

    return _best_of_starts(residuals, x0, lower, upper, max_iter)


class RoughHestonCalibrator:
    """LM surface fit of the rough Heston model.

    Same shape as the classic ``HestonCalibrator`` minus the DE global
    stage: rough fits are typically warm-started from the classic fit
    (H = 0.5, lam = kappa, nu = sigma) and refined — which is also the
    default here when no ``x0`` is given and classic parameters are passed.
    """

    def __init__(self, n_steps: int = 96, max_iter: int = 40):
        self.n_steps = int(n_steps)
        self.max_iter = int(max_iter)
        self.bounds = {
            k: (float(lo), float(hi))
            for k, lo, hi in zip(
                ("hurst", "lam", "theta", "nu", "rho", "v0"), _LOWER, _UPPER
            )
        }

    def calibrate(
        self,
        strikes,
        maturities,
        mid_prices,
        S0: float,
        r: float = 0.0,
        q: float = 0.0,
        x0: Optional[RoughHestonParams] = None,
        classic_params=None,
    ) -> RoughCalibrationResult:
        """Fit to a regular surface: ``strikes``/``mid_prices`` of shape
        (n_maturities, n_strikes), ``maturities`` (n_maturities,).

        ``classic_params`` (a models.heston.HestonParams) seeds the start
        at the classic fit with H = 0.25; an explicit ``x0`` wins.
        """
        from ..core.precision import default_float

        dt = default_float()
        strikes = jnp.asarray(strikes, dt)
        mids = jnp.asarray(mid_prices, dt)
        mats = jnp.asarray(maturities, dt)
        if strikes.ndim != 2 or mids.shape != strikes.shape:
            raise ValueError("strikes/mid_prices must be (n_mat, n_k)")
        if mats.shape != (strikes.shape[0],):
            raise ValueError("maturities must match the surface rows")

        start = self._start(x0, classic_params)
        res = _fit(
            strikes, mats, mids, float(S0), float(r), float(q),
            start, jnp.asarray(_LOWER), jnp.asarray(_UPPER),
            n_steps=self.n_steps, max_iter=self.max_iter,
        )
        return self._package(res, strikes.size)

    def calibrate_quotes(
        self,
        data,
        S0: float,
        r: float = 0.0,
        q: float = 0.0,
        x0: Optional[RoughHestonParams] = None,
        classic_params=None,
    ) -> RoughCalibrationResult:
        """Fit to a FLAT quote vector — the classic calibrator's input
        convention (dict with 'strike', 'maturity', 'mid_price', optional
        'is_call' arrays), so irregular market chains work unchanged and
        the orchestrator can drive both calibrators with one dataset."""
        from ..models.heston import group_maturities

        strikes = np.asarray(data["strike"], np.float64)
        mats = np.asarray(data["maturity"], np.float64)
        mids = np.asarray(data["mid_price"], np.float64)
        is_call = np.asarray(data.get("is_call", np.ones(strikes.shape, bool)))
        if not (strikes.shape == mats.shape == mids.shape == is_call.shape):
            raise ValueError("quote arrays must share one flat shape")
        unique_T, t_idx = group_maturities(mats)

        start = self._start(x0, classic_params)
        res = _fit_flat(
            jnp.asarray(strikes), jnp.asarray(t_idx),
            jnp.asarray(np.asarray(unique_T, np.float64)),
            jnp.asarray(is_call), jnp.asarray(mids),
            float(S0), float(r), float(q),
            start, jnp.asarray(_LOWER), jnp.asarray(_UPPER),
            n_steps=self.n_steps, max_iter=self.max_iter,
        )
        return self._package(res, strikes.size)

    @staticmethod
    def _start(x0, classic_params):
        """Bank of LM starts (k, 6): the primary guess plus deterministic
        H / mean-reversion variations — multistart keeps the f32 device path
        out of single-run damping stalls."""
        if x0 is not None:
            primary = [x0.hurst, x0.lam, x0.theta, x0.nu, x0.rho, x0.v0]
        elif classic_params is not None:
            cp = classic_params
            primary = [0.25, cp.kappa, cp.theta, cp.sigma, cp.rho, cp.v0]
        else:
            primary = [0.2, 2.0, 0.04, 0.4, -0.5, 0.04]
        h, lam, th, nu, rho, v0 = primary
        starts = [
            primary,
            [0.1, lam, th, nu, rho, v0],
            [0.4, 0.5 * lam, th, 0.7 * nu, rho, v0],
            [min(max(h, 0.05), 0.45), 2.0 * lam, th, 1.3 * nu, rho, v0],
        ]
        from ..core.precision import default_float

        bank = np.clip(np.asarray(starts, np.float64), _LOWER, _UPPER)
        return jnp.asarray(bank, default_float())

    @staticmethod
    def _package(res, n_quotes) -> RoughCalibrationResult:
        x = np.asarray(res.x)
        params = RoughHestonParams(*[float(v) for v in x])
        rmse = float(np.sqrt(2.0 * float(res.cost) / n_quotes))
        return RoughCalibrationResult(
            params=params,
            rmse=rmse,
            converged=bool(res.converged),
            n_iter=int(res.n_iter),
            fit_quality={"rel_rmse": rmse, "n_quotes": float(n_quotes)},
        )

    @staticmethod
    def generate_synthetic_surface(
        hurst=0.15, lam=2.0, theta=0.04, nu=0.3, rho=-0.65, v0=0.04,
        S0=100.0, r=0.02, q=0.0,
        strikes=None, maturities=(0.05, 0.25, 1.0), n_steps: int = 96,
    ):
        """Synthetic rough-Heston surface for recovery tests (the analog of
        HestonCalibrator.generate_synthetic_data, reference
        heston_calibrator.py:736)."""
        p = RoughHestonParams(hurst, lam, theta, nu, rho, v0)
        ks = np.linspace(85.0, 115.0, 9) if strikes is None else np.asarray(strikes)
        mats = np.asarray(maturities, dtype=np.float64)
        k_grid = jnp.asarray(np.tile(ks, (len(mats), 1)))
        mids = jax.lax.map(
            lambda args: price_rough(p, args[0], args[1], S0, r, q,
                                     n_steps=n_steps),
            (k_grid, jnp.asarray(mats)),
        )
        return {
            "strikes": np.tile(ks, (len(mats), 1)),
            "maturities": mats,
            "mid_prices": np.asarray(mids),
            "S0": S0, "r": r, "q": q, "true_params": p,
        }
