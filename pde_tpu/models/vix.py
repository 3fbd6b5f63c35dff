"""VIX derivatives under affine stochastic volatility: futures and options.

A capability layer beyond the reference (which prices equity vanillas only —
src/cpp/models/heston.cpp); it completes the volatility-derivative family
started in :mod:`pde_tpu.models.varswap` (variance/vol swaps, VIX-style
strips) with the *traded* VIX instruments.

Under Heston/Bates the forward-looking 30-day strip at time ``T`` is affine
in the instantaneous variance,

    VIX_T^2 / 100^2 = a * v_T + b,
    a = (1 - e^{-kappa tau}) / (kappa tau),      tau = 30/365
    b = theta (1 - a) + jump strip rate,

where the jump contribution per year is ``2 lam (kbar - mu_j)`` — the
log-contract replication bias plus the jump quadratic variation, composed
from the existing ``qv_rate_extra`` / ``strip_jump_bias`` hook pair so any
affine extension that defines those hooks prices VIX products for free.

``v_T`` is CIR, so its terminal law is a scaled noncentral chi-square
``c * chi2_d(lam_nc)`` (Cox-Ingersoll-Ross 1985).  Two independent numerical
routes, cross-validated in tests/test_vix.py:

* **Futures** ``E[sqrt(a v_T + b)]`` — exact via the Schuerger sqrt identity
  applied to the closed-form Laplace transform of ``v_T`` (the same
  machinery as :func:`pde_tpu.models.varswap.fair_volatility_strike`).
* **Options** ``E[(sqrt(a v_T + b) - K)^+]`` — fixed-shape Gauss-Legendre
  quadrature against the exact terminal density, evaluated as a
  Poisson-gamma mixture with a windowed ``logsumexp`` (no Bessel functions,
  no data-dependent shapes — everything jits and vmaps).

The quadrature substitutes ``v = w^4`` so the ``v^{d/2-1}`` endpoint
behaviour is integrable-by-polynomials even when the Feller condition fails
(any ``d = 4 kappa theta / sigma^2 > 1/2``, i.e. far past every market
calibration).

Quoting conventions follow the listed contracts: VIX levels, futures prices
and option strikes are all in **VIX points** (100 x annualized vol); options
settle cash at ``T`` and are quoted/inverted through Black-76 on the future.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln, logsumexp

from ..core.precision import result_dtype
from . import black_scholes as bs

__all__ = [
    "VIX_TENOR",
    "cir_terminal_law",
    "cir_terminal_logpdf",
    "vix_squared_coeffs",
    "vix_spot",
    "vix_futures",
    "vix_futures_density",
    "vix_option",
    "vix_implied_vol",
    "vix_futures_term",
]

VIX_TENOR = 30.0 / 365.0


def cir_terminal_law(params, maturity):
    """(c, d, lam_nc) of the exact CIR terminal law v_T ~ c * chi2_d(lam_nc).

    c = sigma^2 (1 - e^{-kappa T}) / (4 kappa),  d = 4 kappa theta / sigma^2,
    lam_nc = v0 e^{-kappa T} / c.  Works for Heston and any params pytree
    carrying (kappa, theta, sigma, v0) — jumps never hit the variance leg.
    """
    dt = result_dtype(maturity, params.kappa)
    T = jnp.asarray(maturity, dt)
    kappa = jnp.asarray(params.kappa, dt)
    theta = jnp.asarray(params.theta, dt)
    sigma = jnp.asarray(params.sigma, dt)
    v0 = jnp.asarray(params.v0, dt)
    emkt = jnp.exp(-kappa * T)
    c = sigma * sigma * (1.0 - emkt) / (4.0 * kappa)
    d = 4.0 * kappa * theta / (sigma * sigma)
    lam_nc = v0 * emkt / c
    return c, d, lam_nc


def cir_terminal_logpdf(params, maturity, v, *, n_terms: int = 160):
    """log density of v_T — Poisson-gamma mixture, windowed logsumexp.

    chi2_d(lam) = chi2_{d+2N} with N ~ Poisson(lam/2), so the density is a
    Poisson-weighted sum of gamma densities.  A fixed window of ``n_terms``
    consecutive Poisson indices centered on the mode keeps shapes static;
    Poisson mass outside a 160-wide window is < 1e-12 for lam_nc up to ~1e3
    (std = sqrt(lam/2) <~ 22), i.e. any maturity past a couple of days.
    """
    c, d, lam = cir_terminal_law(params, maturity)
    dt = c.dtype
    v = jnp.asarray(v, dt)
    half = jnp.asarray(0.5, dt) * lam
    n0 = jnp.maximum(jnp.floor(half) - n_terms // 2, 0.0)
    ns = n0 + jnp.arange(n_terms, dtype=dt)
    # Poisson(log) mass at ns; xlogy-style guard for lam == 0
    log_half = jnp.log(jnp.maximum(half, jnp.finfo(dt).tiny))
    log_pois = jnp.where(half > 0.0, ns * log_half - half, jnp.where(ns == 0.0, 0.0, -jnp.inf))
    log_pois = log_pois - gammaln(ns + 1.0)
    # gamma(k = d/2 + n, scale = 2) density of y = v / c
    y = jnp.maximum(v / c, jnp.finfo(dt).tiny)[..., None]
    k = 0.5 * d + ns
    log_gamma = (k - 1.0) * jnp.log(y) - 0.5 * y - k * jnp.log(jnp.asarray(2.0, dt)) - gammaln(k)
    return logsumexp(log_pois + log_gamma, axis=-1) - jnp.log(c)


def _jump_strip_rate(params, dt):
    """Per-year jump contribution to the forward strip: 2 lam (kbar - mu_j).

    Composed from the affine-extension hooks (models/bates.py:92-112 and
    varswap.strip_jump_bias): qv_rate_extra + strip bias = 2 lam (kbar-mu_j).
    Zero for pure-diffusion params.
    """
    lam = getattr(params, "lam", None)
    if lam is None:
        return jnp.asarray(0.0, dt)
    lam = jnp.asarray(lam, dt)
    mu_j = jnp.asarray(params.mu_j, dt)
    sj = jnp.asarray(params.sigma_j, dt)
    kbar = jnp.exp(mu_j + 0.5 * sj * sj) - 1.0
    return 2.0 * lam * (kbar - mu_j)


def vix_squared_coeffs(params, tenor=VIX_TENOR):
    """(a, b) with VIX_T^2 (variance units) = a * v_T + b."""
    dt = result_dtype(tenor, params.kappa)
    tau = jnp.asarray(tenor, dt)
    kappa = jnp.asarray(params.kappa, dt)
    theta = jnp.asarray(params.theta, dt)
    a = (1.0 - jnp.exp(-kappa * tau)) / (kappa * tau)
    b = theta * (1.0 - a) + _jump_strip_rate(params, dt)
    return a, b


def vix_spot(params, tenor=VIX_TENOR):
    """Time-0 model VIX level (VIX points): 100 sqrt(a v0 + b)."""
    a, b = vix_squared_coeffs(params, tenor)
    v0 = jnp.asarray(params.v0, a.dtype)
    return 100.0 * jnp.sqrt(a * v0 + b)


def _terminal_log_laplace(params, maturity, s):
    """log E[exp(-s v_T)] — closed form for the noncentral chi-square law.
    Exposed in log form so ``1 - L`` can be built cancellation-free with
    ``expm1`` (float32-safe; see varswap.integrated_variance_log_laplace)."""
    c, d, lam = cir_terminal_law(params, maturity)
    q = 2.0 * c * s
    return -lam * c * s / (1.0 + q) - 0.5 * d * jnp.log1p(q)


@functools.lru_cache(maxsize=8)
def _gl01(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def vix_futures(params, maturity, tenor=VIX_TENOR, *, n_nodes: int = 192):
    """VIX futures price E[VIX_T] (VIX points) — Schuerger route.

    sqrt(y) = 1/(2 sqrt(pi)) int_0^inf (1 - e^{-s y}) s^{-3/2} ds applied to
    Y = a v_T + b, whose Laplace transform is e^{-s b} L_{v_T}(a s); the
    t/(1-t) squared substitution maps to a smooth integrand on (0,1) — the
    same scheme as varswap.fair_volatility_strike (validated there to ~1e-6).
    """
    a, b = vix_squared_coeffs(params, tenor)
    dt = a.dtype
    t_np, w_np = _gl01(int(n_nodes))
    t = jnp.asarray(t_np, dt)
    w = jnp.asarray(w_np, dt)
    u = t / (1.0 - t)
    s = u * u
    log_lap_y = -s * b + _terminal_log_laplace(params, maturity, a * s)
    integrand = -2.0 * jnp.expm1(log_lap_y) / (t * t)
    ev = jnp.sum(w * integrand) / (2.0 * jnp.sqrt(jnp.asarray(np.pi, dt)))
    return 100.0 * ev


def _density_nodes(params, maturity, n_nodes: int):
    """Quadrature nodes/probability-weights for E[f(v_T)].

    Gauss-Legendre in w with v = w^4 on [0, v_max^{1/4}].  The right tail is
    e^{-v/(2c)}-thin, so v_max = mean + 14 std + 72 c (the last term covers
    the low-d/low-lam regime where std << c and the exponential scale 2c
    sets the tail; e^{-36} ~ 2e-16 of mass missed).  Returns (v, prob) with
    prob normalized on the grid — unnormalized mass is asserted ~1 in tests.
    """
    c, d, lam = cir_terminal_law(params, maturity)
    dt = c.dtype
    mean = c * (d + lam)
    std = c * jnp.sqrt(2.0 * d + 4.0 * lam)
    v_max = mean + 14.0 * std + 72.0 * c
    w_hi = v_max ** 0.25
    x_np, wt_np = _gl01(int(n_nodes))
    x = jnp.asarray(x_np, dt) * w_hi
    wt = jnp.asarray(wt_np, dt) * w_hi
    v = x ** 4
    dv_dw = 4.0 * x ** 3
    logpdf = cir_terminal_logpdf(params, maturity, v)
    prob = wt * jnp.exp(logpdf) * dv_dw
    return v, prob


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def vix_futures_density(params, maturity, tenor=VIX_TENOR, *, n_nodes: int = 320):
    """VIX futures via the terminal-density quadrature (independent
    cross-check of :func:`vix_futures`; also the route options use)."""
    a, b = vix_squared_coeffs(params, tenor)
    v, prob = _density_nodes(params, maturity, n_nodes)
    z = jnp.sum(prob)
    return 100.0 * jnp.sum(prob * jnp.sqrt(a * v + b)) / z


@functools.partial(jax.jit, static_argnames=("is_call", "n_nodes"))
def vix_option(params, strike, maturity, rate=0.0, tenor=VIX_TENOR, *,
               is_call: bool = True, n_nodes: int = 320):
    """European VIX option price (VIX points), e^{-rT} E[(VIX_T - K)^+].

    ``strike`` in VIX points; broadcasts over a strike array.  Exact terminal
    law — no simulation bias; tests pin it against put-call parity with the
    Schuerger futures and an exact noncentral-chi-square Monte Carlo.
    """
    a, b = vix_squared_coeffs(params, tenor)
    v, prob = _density_nodes(params, maturity, n_nodes)
    z = jnp.sum(prob)
    strike = jnp.asarray(strike, a.dtype)
    vix_t = 100.0 * jnp.sqrt(a * v + b)
    diff = vix_t - strike[..., None]
    payoff = jnp.maximum(diff, 0.0) if is_call else jnp.maximum(-diff, 0.0)
    T = jnp.asarray(maturity, a.dtype)
    df = jnp.exp(-jnp.asarray(rate, a.dtype) * T)
    return df * jnp.sum(prob * payoff, axis=-1) / z


def vix_implied_vol(price, futures, strike, maturity, rate=0.0, is_call=True):
    """Black-76 implied vol of a VIX option quote (market convention).

    Black-76 = Black-Scholes with spot = F and dividend = rate (forward
    e^{(r-q)T} F = F, discount e^{-rT}), so the existing vectorized Newton
    solver (models/black_scholes.py:286) applies unchanged.
    """
    return bs.implied_vol(price, futures, strike, rate, rate, maturity, is_call=is_call)


def vix_futures_term(params, maturities, tenor=VIX_TENOR, *, n_nodes: int = 192):
    """Futures term structure: vmap of :func:`vix_futures` over maturities."""
    maturities = jnp.atleast_1d(jnp.asarray(maturities))
    return jax.vmap(lambda T: vix_futures(params, T, tenor, n_nodes=n_nodes))(maturities)
