"""SABR smile calibration — per-maturity (alpha, rho, nu) fits.

Mirrors the reference SABRCalibrator (calibration/sabr_calibrator.py): beta
fixed (default 0.5), weighted least-squares smile fit per maturity with an
ATM-vol-derived alpha initial guess (:296-333), forward F = F0 e^{(r-q)T}
(:440), parameter interpolation across maturities (:533-609), synthetic smile
generation (:611-657).

Differences by design: the scipy SLSQP objective loop becomes a jitted
Levenberg-Marquardt on the jnp Hagan formula (pde_tpu.models.sabr — the
reference duplicates the Hagan formula in Python for this, we reuse the one
implementation), and ``calibrate_surface_batch`` fits ALL maturities of a
rectangular surface in one vmapped launch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import sabr as sabr_model
from ..models.sabr import SABRParams
from .lm import levenberg_marquardt

__all__ = ["SABRCalibrationError", "SABRCalibrationResult", "SABRCalibrator"]


class SABRCalibrationError(Exception):
    pass


@dataclass
class SABRCalibrationResult:
    """Surface calibration output (mirrors sabr_calibrator.py:73-105)."""

    params_by_maturity: Dict[float, SABRParams]
    rmse_by_maturity: Dict[float, float]
    total_rmse: float
    calibration_time: float
    n_maturities: int
    n_options: int
    success: bool
    message: str
    timestamp: datetime = field(default_factory=lambda: datetime.now(timezone.utc))
    converged_by_maturity: Dict[float, bool] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "params_by_maturity": {
                str(T): {
                    "alpha": float(p.alpha),
                    "beta": float(p.beta),
                    "rho": float(p.rho),
                    "nu": float(p.nu),
                }
                for T, p in self.params_by_maturity.items()
            },
            "rmse_by_maturity": {str(T): float(v) for T, v in self.rmse_by_maturity.items()},
            "total_rmse": float(self.total_rmse),
            "calibration_time": self.calibration_time,
            "n_maturities": self.n_maturities,
            "n_options": self.n_options,
            "success": self.success,
            "message": self.message,
            "timestamp": self.timestamp.isoformat(),
        }


@partial(jax.jit, static_argnames=("beta", "max_iter"))
def _fit_smile(strikes, market_vols, weights, F, T, x0, lower, upper, beta: float, max_iter: int = 80):
    """LM fit of (alpha, rho, nu) to one smile; weighted residuals."""
    sw = jnp.sqrt(weights / jnp.sum(weights))

    def residuals(x):
        p = SABRParams(alpha=x[0], beta=beta, rho=x[1], nu=x[2])
        model = sabr_model.implied_volatility(strikes, F, T, p)
        return sw * (model - market_vols)

    res = levenberg_marquardt(residuals, x0, lower, upper, max_iter=max_iter)
    model = sabr_model.implied_volatility(
        strikes, F, T, SABRParams(res.x[0], beta, res.x[1], res.x[2])
    )
    rmse = jnp.sqrt(jnp.mean((model - market_vols) ** 2))
    return res.x, rmse, res.converged


class SABRCalibrator:
    """Per-maturity SABR smile calibrator (API parity with the reference)."""

    DEFAULT_BOUNDS = {
        "alpha": (0.001, 2.0),
        "rho": (-0.99, 0.99),
        "nu": (0.001, 3.0),
    }

    def __init__(self, beta: float = 0.5, bounds=None, db_session=None):
        self.beta = float(beta)
        self.bounds = {**self.DEFAULT_BOUNDS, **(bounds or {})}
        self.db_session = db_session
        self._cached_params: Dict[str, Dict[float, SABRParams]] = {}

    # ------------------------------------------------------------------ API

    def sabr_implied_vol(self, F, K, T, alpha, beta, rho, nu):
        """Single-point Hagan vol (reference sabr_calibrator.py:159-258)."""
        return float(
            sabr_model.implied_volatility(K, F, T, SABRParams(alpha, beta, rho, nu))
        )

    def calibrate_single_maturity(
        self,
        strikes: np.ndarray,
        market_vols: np.ndarray,
        F: float,
        T: float,
        weights: Optional[np.ndarray] = None,
        initial_guess: Optional[Dict[str, float]] = None,
    ) -> Tuple[SABRParams, float]:
        """Fit (alpha, rho, nu) for one maturity (sabr_calibrator.py:260-360)."""
        strikes = np.asarray(strikes, dtype=np.float64)
        market_vols = np.asarray(market_vols, dtype=np.float64)
        if len(strikes) < 3:
            raise SABRCalibrationError(
                f"Need at least 3 strikes for SABR calibration, got {len(strikes)}"
            )
        if weights is None:
            weights = np.ones(len(strikes))

        if initial_guess:
            x0 = np.array(
                [
                    initial_guess.get("alpha", 0.3),
                    initial_guess.get("rho", -0.3),
                    initial_guess.get("nu", 0.5),
                ]
            )
        else:
            # alpha from the ATM vol: sigma_ATM ~ alpha / F^(1-beta)
            atm_idx = int(np.argmin(np.abs(strikes - F)))
            alpha_init = market_vols[atm_idx] * F ** (1.0 - self.beta)
            x0 = np.array([alpha_init, -0.3, 0.5])

        lower = jnp.array([self.bounds["alpha"][0], self.bounds["rho"][0], self.bounds["nu"][0]])
        upper = jnp.array([self.bounds["alpha"][1], self.bounds["rho"][1], self.bounds["nu"][1]])

        x, rmse, conv = _fit_smile(
            jnp.asarray(strikes),
            jnp.asarray(market_vols),
            jnp.asarray(weights, dtype=jnp.asarray(strikes).dtype),
            F,
            T,
            jnp.clip(jnp.asarray(x0), lower, upper),
            lower,
            upper,
            beta=self.beta,
        )
        # one batched device->host pull, not one per output
        x, rmse, conv = jax.device_get((x, rmse, conv))
        params = SABRParams(alpha=float(x[0]), beta=self.beta, rho=float(x[1]), nu=float(x[2]))
        self._last_converged = bool(conv)
        return params, float(rmse)

    def calibrate(
        self,
        market_options,
        F0: float,
        r: float = 0.0,
        q: float = 0.0,
        use_forward: bool = True,
        warm_start: Optional[Dict[float, Dict[str, float]]] = None,
        underlying: Optional[str] = None,
    ) -> SABRCalibrationResult:
        """Calibrate across all maturities (sabr_calibrator.py:363-497).

        ``market_options``: DataFrame or dict with 'strike', 'T',
        'implied_vol' and optional 'weight'.
        """
        start = time.time()
        if hasattr(market_options, "columns"):
            get = lambda c: market_options[c].to_numpy()
            has = lambda c: c in market_options.columns
        else:
            get = lambda c: np.asarray(market_options[c])
            has = lambda c: c in market_options

        strikes_all = get("strike").astype(np.float64)
        T_all = get("T").astype(np.float64)
        vols_all = get("implied_vol").astype(np.float64)
        w_all = get("weight").astype(np.float64) if has("weight") else None

        maturities = sorted(np.unique(T_all).tolist())
        params_by_maturity: Dict[float, SABRParams] = {}
        rmse_by_maturity: Dict[float, float] = {}
        converged_by_maturity: Dict[float, bool] = {}
        total_errors = []

        # Regular surfaces (same strike count per maturity, no weights or
        # warm starts) take the batched fast path: every smile fits in ONE
        # vmapped jitted call + one device pull, instead of a Python loop
        # paying a device round-trip per maturity.
        counts = {int(np.sum(T_all == T)) for T in maturities}
        regular = (
            w_all is None and not warm_start and len(counts) == 1
            and counts != {0} and next(iter(counts)) >= 3
        )
        if regular:
            order = np.argsort(T_all, kind="stable")
            Kn = next(iter(counts))
            M = len(maturities)
            s_mat = strikes_all[order].reshape(M, Kn)
            v_mat = vols_all[order].reshape(M, Kn)
            T_arr = np.asarray(maturities)
            F_arr = F0 * np.exp((r - q) * T_arr) if use_forward else np.full(M, F0)
            out = self.calibrate_surface_batch(s_mat, v_mat, F_arr, T_arr)
            for m, T in enumerate(maturities):
                params = SABRParams(
                    alpha=float(out["alpha"][m]), beta=self.beta,
                    rho=float(out["rho"][m]), nu=float(out["nu"][m]),
                )
                params_by_maturity[T] = params
                rmse_by_maturity[T] = float(out["rmse"][m])
                converged_by_maturity[T] = bool(np.asarray(out["converged"])[m])
                total_errors.extend([float(out["rmse"][m]) ** 2] * Kn)
        else:
            for T in maturities:
                mask = T_all == T
                strikes = strikes_all[mask]
                vols = vols_all[mask]
                weights = w_all[mask] if w_all is not None else None
                F = F0 * np.exp((r - q) * T) if use_forward else F0
                guess = warm_start.get(T) if warm_start else None
                try:
                    params, rmse = self.calibrate_single_maturity(
                        strikes, vols, F, T, weights=weights, initial_guess=guess
                    )
                    params_by_maturity[T] = params
                    rmse_by_maturity[T] = rmse
                    converged_by_maturity[T] = getattr(self, "_last_converged", True)
                    model = np.asarray(
                        sabr_model.implied_volatilities(strikes, F, T, params)
                    )
                    total_errors.extend(((model - vols) ** 2).tolist())
                except SABRCalibrationError:
                    rmse_by_maturity[T] = float("inf")

        elapsed = time.time() - start
        total_rmse = float(np.sqrt(np.mean(total_errors))) if total_errors else float("inf")
        all_fitted = len(params_by_maturity) == len(maturities)
        all_converged = all_fitted and all(converged_by_maturity.get(T, False)
                                           for T in maturities)
        success = all_converged

        result = SABRCalibrationResult(
            params_by_maturity=params_by_maturity,
            rmse_by_maturity=rmse_by_maturity,
            total_rmse=total_rmse,
            calibration_time=elapsed,
            n_maturities=len(maturities),
            n_options=len(strikes_all),
            success=success,
            message=(
                "Calibration successful" if success
                else ("Converged on a subset of maturities" if all_fitted
                      else "Partial calibration")
            ),
            converged_by_maturity=converged_by_maturity,
        )
        if underlying:
            self._cached_params[underlying] = params_by_maturity
        return result

    def calibrate_surface_batch(
        self,
        strikes: np.ndarray,
        market_vols: np.ndarray,
        forwards: np.ndarray,
        maturities: np.ndarray,
        x0: Optional[np.ndarray] = None,
    ):
        """Fit a rectangular surface: strikes (M, K), vols (M, K), forwards
        (M,), maturities (M,) — ALL maturities in one vmapped jitted call.
        This is the device fast path the per-maturity Python loop can't reach.
        """
        M, Kn = strikes.shape
        lower = jnp.array([self.bounds["alpha"][0], self.bounds["rho"][0], self.bounds["nu"][0]])
        upper = jnp.array([self.bounds["alpha"][1], self.bounds["rho"][1], self.bounds["nu"][1]])
        if x0 is None:
            atm_idx = np.argmin(np.abs(strikes - forwards[:, None]), axis=1)
            alpha0 = market_vols[np.arange(M), atm_idx] * forwards ** (1.0 - self.beta)
            x0 = np.stack([alpha0, np.full(M, -0.3), np.full(M, 0.5)], axis=1)

        fit = jax.vmap(
            lambda s, v, f, t, x: _fit_smile(
                s, v, jnp.ones_like(s), f, t, jnp.clip(x, lower, upper),
                lower, upper, beta=self.beta,
            )
        )
        xs, rmses, conv = fit(
            jnp.asarray(strikes),
            jnp.asarray(market_vols),
            jnp.asarray(forwards),
            jnp.asarray(maturities),
            jnp.asarray(x0),
        )
        xs, rmses, conv = jax.device_get((xs, rmses, conv))  # one batched pull
        return {
            "alpha": xs[:, 0],
            "rho": xs[:, 1],
            "nu": xs[:, 2],
            "rmse": rmses,
            "converged": conv,
        }

    # -------------------------------------------------- interpolation & gen

    def get_implied_vol(self, K: float, T: float, params_by_maturity: Dict[float, SABRParams], F: float):
        """Vol at arbitrary (K, T) via parameter interpolation across
        maturities (sabr_calibrator.py:499-609)."""
        p = self.interpolate_parameters(T, params_by_maturity)
        return float(sabr_model.implied_volatility(K, F, T, p))

    def interpolate_parameters(
        self, T: float, params_by_maturity: Dict[float, SABRParams]
    ) -> SABRParams:
        """Linear interpolation of (alpha, rho, nu) in maturity; clamped ends."""
        if not params_by_maturity:
            raise SABRCalibrationError("No calibrated parameters to interpolate")
        Ts = sorted(params_by_maturity)
        if T <= Ts[0]:
            return params_by_maturity[Ts[0]]
        if T >= Ts[-1]:
            return params_by_maturity[Ts[-1]]
        hi = next(i for i, t in enumerate(Ts) if t >= T)
        t0, t1 = Ts[hi - 1], Ts[hi]
        w = (T - t0) / (t1 - t0)
        p0, p1 = params_by_maturity[t0], params_by_maturity[t1]
        mix = lambda a, b: float(a) * (1 - w) + float(b) * w
        return SABRParams(
            alpha=mix(p0.alpha, p1.alpha),
            beta=self.beta,
            rho=mix(p0.rho, p1.rho),
            nu=mix(p0.nu, p1.nu),
        )

    @classmethod
    def generate_synthetic_smile(
        cls,
        F: float = 100.0,
        T: float = 0.5,
        alpha: float = 0.25,
        beta: float = 0.5,
        rho: float = -0.3,
        nu: float = 0.5,
        n_strikes: int = 11,
        noise_std: float = 0.0,
        seed: int = 0,
    ):
        """Synthetic smile from known parameters (sabr_calibrator.py:611-657)."""
        strikes = np.linspace(0.8 * F, 1.2 * F, n_strikes)
        vols = np.asarray(
            sabr_model.implied_volatilities(
                strikes, F, T, SABRParams(alpha, beta, rho, nu)
            )
        )
        if noise_std > 0:
            rng = np.random.default_rng(seed)
            vols = np.maximum(vols + rng.normal(0, noise_std, len(vols)), 1e-4)
        return strikes, vols
