"""Rough Heston model — fractional Riccati characteristic function.

A model family BEYOND the reference platform (which stops at classic
Heston, src/cpp/models/heston.cpp): the rough Heston model of El Euch &
Rosenbaum (2019), where instantaneous variance carries a fractional kernel
with Hurst exponent H < 1/2, reproducing the explosive short-maturity ATM
skew (~T^{H-1/2}) that classic Heston structurally cannot.

Characteristic function (El Euch & Rosenbaum, "The characteristic function
of rough Heston models", Math. Finance 29(1), 2019, Thm 4.1): with
alpha = H + 1/2, the log-moneyness CF is

    L(u, t) = exp( theta*lam * I^1 h(u, t)  +  v0 * I^{1-alpha} h(u, t) )

where h solves the fractional Riccati equation

    D^alpha h = F(u, h),   h(u, 0) = 0,
    F(u, x) = 1/2 (-u^2 - i u) + (i u rho nu - lam) x + 1/2 nu^2 x^2.

At alpha = 1 (H = 1/2) this is the classic Heston Riccati ODE with
lam = kappa, nu = sigma — asserted against models/heston._cf_reduced in
tests (the strongest oracle available).

Numerics: an IMPLICIT fractional product-trapezoidal scheme — the
history weights of the fractional Adams corrector (Diethelm-Ford-Freed
2002) with the current-step term solved implicitly, which costs nothing
because F is quadratic in h (closed-form root; see the step body).  The
explicit Adams predictor is unstable on the stiff large-|u| quadrature
nodes; the implicit step is unconditionally stable there while keeping the
same O(dt^{1+alpha}) history accuracy.  The convolutional weight structure
makes each time step a dense dot of the F-history with a weight row —
expressed as a ``lax.scan`` whose body is one (N,) x (N, n_u) contraction,
so the whole O(N^2 n_u) solve is a handful of fused matvecs per step on
the device, batched over ALL quadrature nodes u at once (a scalar loop
would pay the O(N^2) per node).  Weights depend on traced alpha and are
built in-graph; N is static.

Pricing reuses the Carr-Madan forward-moneyness epilogue of
models/heston.py (same damping, same corrected-GL quadrature), so rough
prices drop into every downstream consumer (IV, calibration, signals)
unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import complex_dtype_for, result_dtype
from .heston import (
    INTEGRATION_ALPHA,
    _accurate_gl_rule,
    _price_from_integral,
)

__all__ = [
    "RoughHestonParams",
    "cf_reduced_rough",
    "price_rough",
    "implied_vol_rough",
]


class RoughHestonParams(NamedTuple):
    """Rough Heston parameters.

    hurst: Hurst exponent H in (0, 1/2]; H = 1/2 recovers classic Heston
    lam:   mean-reversion speed (kappa of the classic model)
    theta: long-run variance
    nu:    volatility of variance (sigma of the classic model)
    rho:   spot-variance correlation
    v0:    initial variance
    """

    hurst: float
    lam: float
    theta: float
    nu: float
    rho: float
    v0: float

    def validate(self) -> None:
        if not (0.0 < float(self.hurst) <= 0.5):
            raise ValueError(f"hurst must be in (0, 0.5], got {self.hurst}")
        for name in ("lam", "theta", "nu", "v0"):
            if float(getattr(self, name)) <= 0.0:
                raise ValueError(f"{name} must be positive")
        if not (-1.0 < float(self.rho) < 1.0):
            raise ValueError(f"rho must be in (-1, 1), got {self.rho}")


def _gamma(x):
    """Gamma for positive real arguments (weights only)."""
    return jnp.exp(jax.scipy.special.gammaln(x))


def _riccati_F(u, x, lam, rho, nu, cdt):
    iu = 1j * u.astype(cdt)
    return (
        0.5 * (-u * u - iu)
        + (iu * rho * nu - lam) * x
        + 0.5 * (nu * nu) * x * x
    )


@functools.partial(jax.jit, static_argnames=("n_steps",))
def cf_reduced_rough(params: RoughHestonParams, u, maturity,
                     n_steps: int = 192):
    """exp(theta*lam*I^1 h + v0*I^{1-alpha} h) — the rough-Heston analog of
    models/heston._cf_reduced (no spot/drift phase; the pricer folds that
    into the forward-moneyness phase).  ``u`` may be complex (the damped
    Carr-Madan argument); vectorized over a trailing u axis.
    """
    rdt = result_dtype(maturity, params.lam)
    cdt = complex_dtype_for(rdt)
    u = jnp.atleast_1d(jnp.asarray(u, dtype=cdt))
    T = jnp.asarray(maturity, dtype=rdt)

    alpha = jnp.asarray(params.hurst, rdt) + 0.5
    lam = jnp.asarray(params.lam, rdt)
    rho = jnp.asarray(params.rho, rdt)
    nu = jnp.asarray(params.nu, rdt)
    theta = jnp.asarray(params.theta, rdt)
    v0 = jnp.asarray(params.v0, rdt)

    N = int(n_steps)
    dt = T / N
    f = functools.partial(_riccati_F, u, lam=lam, rho=rho, nu=nu, cdt=cdt)

    # --- Adams weights, built in-graph from (traced) alpha ---------------
    ks = jnp.arange(N, dtype=rdt)               # step index k = 0..N-1
    js = jnp.arange(N, dtype=rdt)               # history index j = 0..N-1
    m = ks[:, None] - js[None, :]               # k - j
    valid = m >= 0.0
    mp = jnp.maximum(m, 0.0)
    g = alpha + 1.0

    # corrector history weights, interior j=1..k:
    # (m+2)^g - 2(m+1)^g + m^g with m = k-j
    A = jnp.where(valid, (mp + 2.0) ** g - 2.0 * (mp + 1.0) ** g + mp ** g, 0.0)
    # j = 0 column: k^g - (k - alpha)(k+1)^alpha
    a0 = ks ** g - (ks - alpha) * (ks + 1.0) ** alpha
    A = A.at[:, 0].set(a0)

    c_corr = (dt ** alpha / _gamma(alpha + 2.0)).astype(cdt)

    # IMPLICIT product-trapezoidal step.  The explicit Adams
    # predictor-corrector (Diethelm-Ford-Freed) blows up on the stiff
    # large-|u| quadrature nodes (F ~ -u^2/2 forces |h_pred| ~ dt^alpha u^2,
    # then the nu^2 h^2 term amplifies — observed NaN at H=0.1, T=0.5).
    # Making the current-step term implicit costs nothing here because F is
    # QUADRATIC in h: h = K + c F(h) is
    #
    #   (c a2) h^2 + (c b1 - 1) h + (K + c f0) = 0,
    #   a2 = nu^2/2,  b1 = i u rho nu - lam,  f0 = (-u^2 - iu)/2,
    #
    # solved in closed form with the root that is continuous at c -> 0
    # (h -> K + c f0), via the cancellation-free form 2C / (-B + sqrt(disc)).
    f0 = 0.5 * (-u * u - 1j * u)
    b1 = 1j * u * (rho * nu) - lam
    a2 = jnp.asarray(0.5 * nu * nu, cdt)

    n_u = u.shape[0]
    fhist0 = jnp.zeros((N, n_u), dtype=cdt)
    fhist0 = fhist0.at[0].set(f(jnp.zeros((n_u,), cdt)))  # f(h_0 = 0)

    def step(carry, a_row):
        fhist, k = carry
        K = c_corr * (a_row.astype(cdt) @ fhist)
        A_q = c_corr * a2
        B_q = c_corr * b1 - 1.0
        C_q = K + c_corr * f0
        disc = jnp.sqrt(B_q * B_q - 4.0 * A_q * C_q)
        h_new = 2.0 * C_q / (-B_q + disc)
        fhist = jax.lax.dynamic_update_slice(
            fhist, f(h_new)[None, :], (k + 1, 0)
        )
        return (fhist, k + 1), h_new

    (_, _), h_hist = jax.lax.scan(step, (fhist0, jnp.asarray(0)), A)
    # h at t_0..t_N (h_0 = 0); the last update-slice lands out of range and
    # is clamped by XLA — fhist[N] is never read, h_hist carries the values.
    h = jnp.concatenate([jnp.zeros((1, n_u), cdt), h_hist], axis=0)

    # --- I^1 h(T): trapezoid over the uniform grid ------------------------
    i1 = dt * (jnp.sum(h, axis=0) - 0.5 * (h[0] + h[-1]))

    # --- I^{1-alpha} h(T): product-trapezoidal Abel integral ---------------
    # piecewise-linear h => weights (m+1)^gg - 2 m^gg + (m-1)^gg, m = N - j,
    # gg = 2 - alpha; endpoint j = N gets weight 1; j = 0 multiplies h_0 = 0.
    gg = 2.0 - alpha
    jj = jnp.arange(1, N, dtype=rdt)
    mm = N - jj
    w_int = (mm + 1.0) ** gg - 2.0 * mm ** gg + (mm - 1.0) ** gg
    i_frac = (dt ** (1.0 - alpha) / _gamma(3.0 - alpha)) * (
        w_int.astype(cdt) @ h[1:N] + h[N]
    )

    cf = jnp.exp(theta * lam * i1 + v0 * i_frac)
    # T <= 0: CF of a point mass at 0 log-moneyness
    return jnp.where(T <= 0.0, jnp.asarray(1.0 + 0.0j, cdt), cf)


@functools.partial(
    jax.jit, static_argnames=("n_per_panel", "n_steps", "alpha")
)
def price_rough(
    params: RoughHestonParams,
    strikes,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_per_panel: int = 40,
    n_steps: int = 192,
    alpha: float = INTEGRATION_ALPHA,
):
    """European vanillas under rough Heston, one maturity (a smile).

    Same Carr-Madan forward-moneyness formulation as the classic pricer
    (models/heston; reference integrand src/cpp/models/heston.cpp:94-151)
    with the CF swapped for the fractional-Riccati one.  Quadrature: the
    CONVERGED composite-GL rule (models/heston._accurate_gl_rule), NOT the
    reference-parity grid — that grid truncates at u = 10.24, which loses
    real mass at short maturities, exactly the regime rough volatility
    exists for.  The CF is evaluated once on the quadrature grid and shared
    across ALL strikes of the smile.
    """
    rdt = result_dtype(strikes, maturity, spot)
    cdt = complex_dtype_for(rdt)
    strikes = jnp.atleast_1d(jnp.asarray(strikes, dtype=rdt))
    T = jnp.asarray(maturity, dtype=rdt)
    spot = jnp.asarray(spot, dtype=rdt)

    v_np, w_np = _accurate_gl_rule(n_per_panel)
    v = jnp.asarray(v_np, dtype=rdt)
    w = jnp.asarray(w_np, dtype=rdt)

    u = v.astype(cdt) - 1j * (alpha + 1.0)
    cf = cf_reduced_rough(params, u, T, n_steps=n_steps)   # (n_u,)

    log_fk = (jnp.log(spot / strikes) + (rate - dividend) * T)[..., None]
    phase = jnp.exp(1j * v.astype(cdt) * log_fk.astype(cdt))
    denom = (alpha * alpha + alpha - v * v) + 1j * ((2.0 * alpha + 1.0) * v)
    integrand = (cf[None, :] * phase / denom).real
    integral = 1.0 * jnp.sum(w * integrand, axis=-1)

    return _price_from_integral(
        integral, strikes, T, spot, rate, dividend, is_call, alpha, rdt
    )


def implied_vol_rough(
    params: RoughHestonParams,
    strikes,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_per_panel: int = 40,
    n_steps: int = 192,
):
    """Black-Scholes implied vols of the rough-Heston smile (the quantity
    the short-maturity skew literature plots)."""
    from .black_scholes import implied_vol as bs_implied_vol

    prices = price_rough(
        params, strikes, maturity, spot, rate, dividend, is_call,
        n_per_panel=n_per_panel, n_steps=n_steps,
    )
    return bs_implied_vol(
        prices, jnp.asarray(spot), jnp.atleast_1d(jnp.asarray(strikes)),
        rate, dividend, jnp.asarray(maturity), is_call,
    )
