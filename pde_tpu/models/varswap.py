"""Volatility derivatives: variance swaps, volatility swaps, VIX-style strips.

A capability layer on top of the affine models (beyond the reference, which
prices vanillas only — src/cpp/models/heston.cpp): under Heston the integrated
variance I_T = (1/T)||[0,T] v_t dt has closed-form moments and a closed-form
Laplace transform (the CIR bond-price formula), so

* the **variance-swap fair strike** E[I_T] is exact and free,
* the **volatility-swap fair strike** E[sqrt(I_T)] is exact through one
  Gauss-Legendre quadrature of the Laplace transform (Schuerger's identity
  sqrt(x) = 1/(2 sqrt(pi)) * int_0^inf (1 - e^{-s x}) s^{-3/2} ds),
* the **VIX-style model-free strip** replicates variance from an OTM option
  chain (CBOE 2003 discretization) and, on CF-priced chains, cross-validates
  both of the above to quadrature tolerance.

Bates jumps compose exactly: quadratic variation gains an independent
compound-Poisson term whose Laplace transform is the Gaussian-square
transform, wired through the same params-pytree hook pattern as pricing
(``qv_rate_extra`` / ``qv_laplace_extra`` on
:class:`~pde_tpu.models.bates.BatesParams`, mirroring ``cf_reduced_extra``).
The log-contract strip is *biased* under jumps by a known closed form
(Demeterfi et al. 1999; Broadie-Jain 2008), exposed as
:func:`strip_jump_bias` and regression-tested.

All functions are jittable, vmap over maturities/params, and run float32 on
the device (the Laplace quadrature is a smooth bounded integrand — no parity-grade
precision needed for swap strikes quoted in vol points).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import result_dtype

__all__ = [
    "integrated_variance_laplace",
    "integrated_variance_log_laplace",
    "fair_variance_strike",
    "forward_variance",
    "fair_volatility_strike",
    "volatility_convexity_approx",
    "strip_variance",
    "strip_jump_bias",
    "vix_index",
]


def integrated_variance_laplace(params, s, maturity):
    """E[exp(-s * int_0^T v_t dt)] — closed-form CIR transform.

    The Cox-Ingersoll-Ross bond-price formula with the short rate replaced
    by ``s * v_t``:

        gamma = sqrt(kappa^2 + 2 sigma^2 s)
        L(s)  = A(s)^{2 kappa theta / sigma^2} * exp(-B(s) v0)

    written in decaying exponentials so large ``gamma*T`` cannot overflow.
    If ``params`` carries ``qv_laplace_extra(s, T)`` (Bates: the transform of
    the independent jump quadratic variation), it multiplies in — same hook
    pattern as models/heston.py:_cf_reduced.
    """
    return jnp.exp(integrated_variance_log_laplace(params, s, maturity))


def integrated_variance_log_laplace(params, s, maturity):
    """log E[exp(-s * int_0^T v_t dt)] — the exponent of
    :func:`integrated_variance_laplace`, exposed so small-``s`` callers can
    form ``1 - L`` cancellation-free via ``-expm1(log L)`` (the Schuerger
    integrand is dominated by the s -> 0 region, where ``1 - exp(tiny)``
    loses all float32 precision)."""
    dt = result_dtype(s, maturity, params.kappa)
    s = jnp.asarray(s, dt)
    T = jnp.asarray(maturity, dt)
    kappa = jnp.asarray(params.kappa, dt)
    theta = jnp.asarray(params.theta, dt)
    sigma = jnp.asarray(params.sigma, dt)
    v0 = jnp.asarray(params.v0, dt)

    gamma = jnp.sqrt(kappa * kappa + 2.0 * sigma * sigma * s)
    e = jnp.exp(-gamma * T)
    denom = (gamma + kappa) * (1.0 - e) + 2.0 * gamma * e
    # A = [2 gamma e^{(gamma+kappa)T/2} / ((gamma+kappa)(e^{gamma T}-1)+2 gamma)]^{2 k th / s^2}
    #   = [2 gamma e^{(kappa-gamma)T/2} / denom]^{...}   (both factors decay)
    log_a = jnp.log(2.0 * gamma / denom) + 0.5 * (kappa - gamma) * T
    b = 2.0 * s * (1.0 - e) / denom
    out = (2.0 * kappa * theta / (sigma * sigma)) * log_a - b * v0
    extra = getattr(params, "qv_log_laplace_extra", None)
    if extra is not None:
        out = out + extra(s, T)
    else:
        extra_lin = getattr(params, "qv_laplace_extra", None)
        if extra_lin is not None:
            out = out + jnp.log(extra_lin(s, T))
    return out


def fair_variance_strike(params, maturity):
    """Variance-swap fair strike E[(1/T) int_0^T v dt] (+ jump QV rate).

    Heston: theta + (v0 - theta)(1 - e^{-kappa T})/(kappa T), exact.  A
    ``qv_rate_extra()`` hook on the params (Bates: lam*(mu_j^2 + sigma_j^2),
    the expected jump quadratic variation per year) adds in.
    """
    dt = result_dtype(maturity, params.kappa)
    T = jnp.asarray(maturity, dt)
    kappa = jnp.asarray(params.kappa, dt)
    theta = jnp.asarray(params.theta, dt)
    v0 = jnp.asarray(params.v0, dt)
    ev = theta + (v0 - theta) * (1.0 - jnp.exp(-kappa * T)) / (kappa * T)
    # maturity-aware hook first (SVCJ: v-jumps bend the forward variance
    # curve, so the jump QV contribution depends on T), then the constant
    # jump-QV-rate hook (Bates)
    extra_t = getattr(params, "qv_mean_extra", None)
    extra = getattr(params, "qv_rate_extra", None)
    if extra_t is not None:
        ev = ev + extra_t(T)
    elif extra is not None:
        ev = ev + extra()
    return ev


def forward_variance(params, t1, t2):
    """Forward variance-swap strike over [t1, t2] from the term structure:
    (E[I_{t2}] t2 - E[I_{t1}] t1) / (t2 - t1)."""
    dt = result_dtype(t1, t2, params.kappa)
    t1 = jnp.asarray(t1, dt)
    t2 = jnp.asarray(t2, dt)
    k2 = fair_variance_strike(params, t2)
    k1 = fair_variance_strike(params, t1)
    return (k2 * t2 - k1 * t1) / (t2 - t1)


@functools.lru_cache(maxsize=8)
def _gl01(n: int):
    """Gauss-Legendre nodes/weights on (0, 1) as numpy (host, cached)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def fair_volatility_strike(params, maturity, *, n_nodes: int = 128):
    """Volatility-swap fair strike E[sqrt((1/T) int v dt)] — EXACT (to
    quadrature), not a convexity expansion.

    Schuerger's identity turns the expectation into a Laplace-transform
    integral; the substitution s = (t/(1-t))^2 maps it to a smooth bounded
    integrand on (0, 1) (limits 2 E[I] at t=0 and 2 at t=1), which ``n_nodes``
    Gauss-Legendre points nail to ~1e-6:

        E[sqrt(I)] = 1/(2 sqrt(pi)) * int_0^1 2 (1 - L((t/(1-t))^2)) / t^2 dt
    """
    dt = result_dtype(maturity, params.kappa)
    t_np, w_np = _gl01(int(n_nodes))
    t = jnp.asarray(t_np, dt)
    w = jnp.asarray(w_np, dt)
    u = t / (1.0 - t)
    s = u * u
    # L is the transform of T*I (the raw integral); rescale to the
    # annualized I by evaluating at s/T
    T = jnp.asarray(maturity, dt)
    log_lap = integrated_variance_log_laplace(params, s / T, maturity)
    # 1 - L via -expm1(log L): at the dominant s -> 0 end the direct form
    # 1 - exp(-s E[I]) is pure cancellation in float32 (device path)
    integrand = -2.0 * jnp.expm1(log_lap) / (t * t)
    return jnp.sum(w * integrand) / (2.0 * jnp.sqrt(jnp.asarray(np.pi, dt)))


def volatility_convexity_approx(params, maturity):
    """Second-order convexity approximation sqrt(E[I]) (1 - Var(I)/(8 E[I]^2))
    (Brockhaus-Long 2000) — the desk rule of thumb; kept for comparison with
    the exact quadrature (tests assert they agree for moderate vol-of-vol).

    Var(I) comes from AD second derivatives of the log-Laplace transform at
    s = 0 — no hand-derived CIR variance formula to get wrong.
    """
    T = jnp.asarray(maturity, result_dtype(maturity, params.kappa))

    def log_lap(s):
        return jnp.log(integrated_variance_laplace(params, s / T, maturity))

    mean = -jax.grad(log_lap)(jnp.zeros_like(T))   # = E[I]
    var = jax.grad(jax.grad(log_lap))(jnp.zeros_like(T))  # cumulant: Var[I]
    mean = jnp.maximum(mean, 1e-12)
    return jnp.sqrt(mean) * (1.0 - var / (8.0 * mean * mean))


def strip_variance(strikes, otm_prices, forward, maturity, rate):
    """Model-free variance from an OTM option strip — the CBOE VIX (2003)
    discretization of the Demeterfi et al. (1999) log-contract replication:

        sigma^2 = (2 e^{rT} / T) sum_i (dK_i / K_i^2) Q(K_i)
                  - (1/T) (F/K0 - 1)^2

    ``strikes`` ascending; ``otm_prices`` are present-value option mid
    prices (puts below the forward, calls above — the usual OTM quote
    convention; the e^{rT} factor undiscounts them); K0 is the largest
    strike at or below F.  Vectorized,
    jittable, differentiable (the K0 selection uses a mask, not argmax
    control flow).
    """
    dt = result_dtype(strikes, otm_prices, forward, maturity, rate)
    K = jnp.asarray(strikes, dt)
    Q = jnp.asarray(otm_prices, dt)
    F = jnp.asarray(forward, dt)
    T = jnp.asarray(maturity, dt)
    r = jnp.asarray(rate, dt)

    # central strike spacing, one-sided at the ends (CBOE rule)
    dK = jnp.concatenate([
        (K[1:2] - K[0:1]),
        0.5 * (K[2:] - K[:-2]),
        (K[-1:] - K[-2:-1]),
    ])
    total = jnp.sum(dK / (K * K) * Q)
    # K0 = max strike <= F (mask-select; falls back to K[0] if F < all K)
    below = jnp.where(K <= F, K, K[0])
    K0 = jnp.max(below)
    return (2.0 * jnp.exp(r * T) / T) * total - ((F / K0 - 1.0) ** 2) / T


def strip_jump_bias(params):
    """Closed-form bias of the log-contract strip under jumps, per year.

    The strip replicates 2 E[dS/S - d ln S]; each jump contributes
    2(e^J - 1 - J) instead of its true quadratic variation J^2, so

        strip - fair_variance = lam * E[2(e^J - 1 - J) - J^2]
                              = 2 lam (kbar - mu_j) - lam (mu_j^2 + sigma_j^2)

    Zero when the params carry no jump fields (pure diffusion: the strip is
    exact).  Used by tests to pin the strip against the CF pricers.
    """
    lam = getattr(params, "lam", None)
    if lam is None:
        return jnp.asarray(0.0)
    lam = jnp.asarray(lam)
    mu_j = jnp.asarray(params.mu_j)
    sj = jnp.asarray(params.sigma_j)
    kbar = jnp.exp(mu_j + 0.5 * sj * sj) - 1.0
    return 2.0 * lam * (kbar - mu_j) - lam * (mu_j * mu_j + sj * sj)


def vix_index(strikes, otm_prices, forward, maturity, rate):
    """VIX-style index: 100 * sqrt(strip variance) at the given tenor
    (the CBOE index interpolates two tenors to 30 days; single-tenor here —
    callers with two chains can interpolate the squared values in T)."""
    var = strip_variance(strikes, otm_prices, forward, maturity, rate)
    return 100.0 * jnp.sqrt(jnp.maximum(var, 0.0))
