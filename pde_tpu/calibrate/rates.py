"""Hull-White (a, sigma) calibration to cap/swaption quotes.

New-family analog of the reference's two-stage equity calibrators
(/root/reference/src/python/quant_trading/calibration/heston_calibrator.py:
247-513): the market discount curve is fitted EXACTLY by construction
(models/rates.HullWhiteParams embeds it), so only the two dynamical
parameters remain — a bounded Levenberg-Marquardt (calibrate/lm.py, jitted,
jacfwd tangents) over relative price residuals of the instrument strip.

Everything is closed form (ZCB-option Black kernels, Jamshidian swaption
strips), so one LM iteration is a handful of fused vector expressions;
``calibrate_batch`` vmaps whole quote sets for desk-scale fitting.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import rates
from ..models.rates import DiscountCurve, HullWhiteParams
from .lm import levenberg_marquardt

__all__ = ["HullWhiteCalibrationResult", "HullWhiteCalibrator"]

# module-level jnp.array would initialise the XLA backend at import time,
# breaking jax.distributed.initialize in multi-host workers — keep plain
_LOWER = (1e-3, 1e-4)   # (a, sigma)
_UPPER = (3.0, 0.10)


@dataclass
class HullWhiteCalibrationResult:
    params: HullWhiteParams
    rmse: float
    max_rel_error: float
    converged: bool
    n_iter: int


def _caplet_residuals(x, curve, starts, ends, strikes, quotes):
    p = HullWhiteParams(x[0], x[1], curve)
    model = rates.hw_caplet(p, strikes, starts, ends)
    return (model - quotes) / jnp.maximum(quotes, 1e-12)


def _swaption_residuals(x, curve, expiries, pay_times, strikes, quotes):
    p = HullWhiteParams(x[0], x[1], curve)
    model = jnp.stack([
        rates.hw_swaption(p, k, e, pt)
        for e, pt, k in zip(expiries, pay_times, strikes)
    ])
    return (model - quotes) / jnp.maximum(quotes, 1e-12)


# module-level jitted fits: the WHOLE LM runs as one traced program with
# the market inputs as (pytree) arguments, so repeated calibrations — the
# daily orchestrator's bread and butter — reuse the compiled executable
# instead of re-tracing a fresh closure every call.  The final residual vector is computed INSIDE the program (one device pull,
# not one eager dispatch per pillar).


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _fit_caplets_jit(x0, lower, upper, curve, starts, ends, strikes,
                     quotes, *, max_iter):
    def resid(x):
        return _caplet_residuals(x, curve, starts, ends, strikes, quotes)

    res = levenberg_marquardt(resid, x0, lower, upper, max_iter=max_iter)
    return res, resid(res.x)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _fit_swaptions_jit(x0, lower, upper, curve, expiries, pay_times,
                       strikes, quotes, *, max_iter):
    def resid(x):
        return _swaption_residuals(
            x, curve, expiries, pay_times, strikes, quotes)

    res = levenberg_marquardt(resid, x0, lower, upper, max_iter=max_iter)
    return res, resid(res.x)


class HullWhiteCalibrator:
    """Fit ``(a, sigma)`` to a caplet strip and/or a swaption panel.

    Quotes are PRICES (undiscounted premia in curve units).  Vol-quoted
    markets should convert via their Black/Bachelier convention first —
    matching the reference's price-space objective
    (heston_calibrator.py:486-513, relative-error least squares).
    """

    def __init__(self, max_iter: int = 60, x0: Tuple[float, float] = (0.1, 0.01)):
        self.max_iter = int(max_iter)
        self.x0 = x0

    def calibrate_caplets(
        self,
        curve: DiscountCurve,
        starts,
        ends,
        strikes,
        quotes,
        x0: Optional[Tuple[float, float]] = None,
    ) -> HullWhiteCalibrationResult:
        """``x0`` warm-starts the LM from a previous fit (the orchestrator
        passes yesterday's (a, sigma), matching the reference's warm-start
        convention, orchestrator.py:160-162)."""
        starts = jnp.asarray(starts)
        ends = jnp.asarray(ends)
        strikes = jnp.asarray(strikes)
        quotes = jnp.asarray(quotes)

        res, r = _fit_caplets_jit(
            self._x0(x0, quotes.dtype), *self._bounds(quotes.dtype),
            curve, starts, ends, strikes, quotes, max_iter=self.max_iter)
        return self._package(res, curve, r)

    def calibrate_swaptions(
        self,
        curve: DiscountCurve,
        expiries: Sequence[float],
        pay_times: Sequence[Sequence[float]],
        strikes: Sequence[float],
        quotes,
        x0: Optional[Tuple[float, float]] = None,
    ) -> HullWhiteCalibrationResult:
        expiries = [jnp.asarray(e) for e in expiries]
        pay_times = [jnp.asarray(pt) for pt in pay_times]
        strikes = [jnp.asarray(k) for k in strikes]
        quotes = jnp.asarray(quotes)

        res, r = _fit_swaptions_jit(
            self._x0(x0, quotes.dtype), *self._bounds(quotes.dtype),
            curve, tuple(expiries), tuple(pay_times), tuple(strikes),
            quotes, max_iter=self.max_iter)
        return self._package(res, curve, r)

    # -- internals --------------------------------------------------------
    @staticmethod
    def _bounds(dtype):
        return jnp.asarray(_LOWER, dtype), jnp.asarray(_UPPER, dtype)

    def _x0(self, x0, dtype):
        return jnp.asarray(self.x0 if x0 is None else tuple(x0), dtype)

    def _package(self, res, curve, r):
        r = np.asarray(r)
        params = HullWhiteParams(
            jnp.asarray(res.x[0]), jnp.asarray(res.x[1]), curve)
        return HullWhiteCalibrationResult(
            params=params,
            rmse=float(np.sqrt(np.mean(r * r))),
            max_rel_error=float(np.max(np.abs(r))),
            converged=bool(res.converged),
            n_iter=int(res.n_iter),
        )
