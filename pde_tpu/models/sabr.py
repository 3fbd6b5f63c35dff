"""SABR model: Hagan et al. (2002) asymptotic implied volatility.

Redesign of the reference C++ implementation (src/cpp/models/sabr.{hpp,cpp})
as a single branch-free broadcasting jnp expression: every conditional in the
scalar C++ (small-z Taylor of chi, ATM detection, zero-maturity shortcut,
rho -> 1 limit) becomes a ``jnp.where`` with NaN-safe guarded operands, so one
call evaluates an entire (strikes x maturities) surface as one vector op and the
formula is differentiable — parameter sensitivities come from ``jax.grad``
instead of the reference's finite differences (sabr.cpp:250-280).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype

__all__ = [
    "SABRParams",
    "implied_volatility",
    "implied_volatilities",
    "atm_volatility",
    "volatility_sensitivities",
    "volatility_smile",
]

_EPSILON = 1e-10  # numerical-comparison epsilon (sabr.cpp:12)
_ATM_THRESHOLD = 1e-6  # |log(F/K)| ATM cutoff (sabr.cpp:15)


class SABRParams(NamedTuple):
    """SABR parameters (alpha, beta, rho, nu) as a JAX pytree."""

    alpha: jnp.ndarray
    beta: jnp.ndarray
    rho: jnp.ndarray
    nu: jnp.ndarray

    def validate(self) -> None:
        import numpy as np

        a, b, r, n = (np.asarray(x) for x in self)
        if np.any(a <= 0):
            raise ValueError("alpha must be positive")
        if np.any((b < 0) | (b > 1)):
            raise ValueError("beta must be in [0, 1]")
        if np.any(np.abs(r) >= 1):
            raise ValueError("|rho| must be < 1")
        if np.any(n < 0):
            raise ValueError("nu must be non-negative")


def _chi(z, rho):
    """chi(z) = ln((sqrt(1-2 rho z + z^2) + z - rho) / (1 - rho)).

    Small-z third-order Taylor branch for stability, numerator floored at
    epsilon — matching SABRModel::chi_function (sabr.cpp:32-62).
    """
    small = jnp.abs(z) < _EPSILON
    taylor = z * (1.0 + 0.5 * rho * z + (2.0 * rho * rho - 1.0) / 6.0 * z * z)

    sqrt_term = jnp.sqrt(jnp.maximum(1.0 - 2.0 * rho * z + z * z, 0.0))
    numer = jnp.maximum(sqrt_term + z - rho, _EPSILON)
    denom = 1.0 - rho
    full = jnp.log(numer / jnp.where(jnp.abs(denom) < _EPSILON, _EPSILON, denom))
    return jnp.where(small, taylor, full)


def _correction_factor(strike, forward, maturity, alpha, beta, rho, nu):
    """[1 + (term1 + term2 + term3) * T]  (sabr.cpp:79-99)."""
    omb = 1.0 - beta
    fk_mid = jnp.sqrt(forward * strike)
    fk_pow = fk_mid**omb
    term1 = (omb * omb / 24.0) * (alpha * alpha) / (fk_pow * fk_pow)
    term2 = (rho * beta * nu * alpha) / (4.0 * fk_pow)
    term3 = ((2.0 - 3.0 * rho * rho) / 24.0) * nu * nu
    return 1.0 + (term1 + term2 + term3) * maturity


def atm_volatility(forward, maturity, params: SABRParams):
    """Hagan Eq. 2.18 ATM volatility (sabr.cpp:101-144)."""
    alpha, beta, rho, nu = params
    omb = 1.0 - beta
    f_pow = forward**omb
    base = alpha / f_pow
    term1 = (omb * omb / 24.0) * alpha * alpha / (f_pow * f_pow)
    term2 = (rho * beta * nu * alpha) / (4.0 * f_pow)
    term3 = ((2.0 - 3.0 * rho * rho) / 24.0) * nu * nu
    return base * (1.0 + (term1 + term2 + term3) * maturity)


def implied_volatility(strike, forward, maturity, params: SABRParams):
    """Hagan Eq. 2.17a lognormal implied vol; broadcasts over all inputs.

    Branch structure mirrors SABRModel::implied_volatility
    (sabr.cpp:146-216): zero-maturity shortcut, ATM shortcut at
    |log(F/K)| < 1e-6, otherwise the full formula with the 1/24 + 1/1920
    log-moneyness series and z/chi(z) ratio.
    """
    alpha, beta, rho, nu = params
    rdt = result_dtype(strike, forward, maturity, alpha)
    strike = jnp.asarray(strike, dtype=rdt)
    forward = jnp.asarray(forward, dtype=rdt)
    maturity = jnp.asarray(maturity, dtype=rdt)

    omb = 1.0 - beta
    log_fk = jnp.log(forward / strike)
    fk_mid = jnp.sqrt(forward * strike)
    fk_pow = fk_mid**omb

    # z and chi(z)   (sabr.cpp:64-77)
    degenerate = (nu < _EPSILON) | (alpha < _EPSILON)
    z = jnp.where(degenerate, 0.0, (nu / jnp.maximum(alpha, _EPSILON)) * fk_pow * log_fk)
    z_over_chi = jnp.where(jnp.abs(z) < _EPSILON, 1.0, z / _chi(z, rho))

    log_fk_sq = log_fk * log_fk
    series = 1.0 + (omb * omb / 24.0) * log_fk_sq + (omb**4 / 1920.0) * log_fk_sq * log_fk_sq
    sigma_base = (alpha / (fk_pow * series)) * z_over_chi
    non_atm = sigma_base * _correction_factor(strike, forward, maturity, alpha, beta, rho, nu)

    atm = atm_volatility(forward, maturity, params)
    vol = jnp.where(jnp.abs(log_fk) < _ATM_THRESHOLD, atm, non_atm)

    # zero maturity: instantaneous vol alpha / (F K)^((1-beta)/2)  (sabr.cpp:169-173)
    return jnp.where(maturity < _EPSILON, alpha / fk_pow, vol)


def implied_volatilities(strikes, forward, maturity, params: SABRParams):
    """Vectorized smile — the OpenMP loop of sabr.cpp:218-231 as one tensor op."""
    return implied_volatility(jnp.asarray(strikes), forward, maturity, params)


def volatility_sensitivities(strike, forward, maturity, params: SABRParams):
    """(d sigma/d alpha, d sigma/d rho, d sigma/d nu) via automatic differentiation.

    The reference computes these with central finite differences
    (sabr.cpp:250-280); AD gives them exactly at the same cost.
    """

    def vol(alpha, rho, nu):
        p = SABRParams(alpha=alpha, beta=params.beta, rho=rho, nu=nu)
        return implied_volatility(strike, forward, maturity, p)

    d_alpha, d_rho, d_nu = jax.jacfwd(vol, argnums=(0, 1, 2))(
        jnp.asarray(params.alpha), jnp.asarray(params.rho), jnp.asarray(params.nu)
    )
    return d_alpha, d_rho, d_nu


def volatility_smile(strikes, forward, maturity, params: SABRParams):
    """Convenience alias matching models/sabr.py:291 in the reference."""
    return implied_volatilities(strikes, forward, maturity, params)
