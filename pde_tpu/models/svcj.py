"""SVCJ — stochastic volatility with correlated jumps in price AND variance
(Duffie-Pan-Singleton 2000).

Bates adds jumps to the price only; SVCJ jumps both state variables at the
same Poisson arrivals:

    dS/S = (r - q - lam*kbar) dt + sqrt(v) dW_S + (e^{Z_x} - 1) dN
    dv   = kappa (theta - v) dt + sigma sqrt(v) dW_v + Z_v dN

with ``Z_v ~ Exp(mu_v)`` and ``Z_x | Z_v ~ N(mu_x + rho_j Z_v, sigma_x^2)``
— the empirically-documented co-jump structure (vol spikes WITH price
crashes; Eraker-Johannes-Polson 2003).  The martingale compensator is
``kbar = E[e^{Z_x}] - 1 = exp(mu_x + sigma_x^2/2) / (1 - rho_j mu_v) - 1``
(requires ``rho_j * mu_v < 1``).

This family is beyond the reference (dharvpat/PDE ships Heston/SABR/OU
only, src/cpp/models/) and one level beyond this build's own Bates module:
because the v-jump enters the characteristic function through the Riccati
solution ``D(s)``, its CF correction is NOT a simple multiplicative
``Phi_J(u)`` factor — it is the **time-integrated jump transform**

    lam * INT_0^T [ e^{i u mu_x - sigma_x^2 u^2 / 2}
                    / (1 - mu_v rho_j i u - mu_v D(s)) - 1 ] ds
    - i u lam kbar T

which this module evaluates in CLOSED FORM (the integrand is rational in
``e^{-d s}``; see ``_int_recip_affine``).  The result still plugs into the
SAME ``cf_reduced_extra`` hook (models/heston.py:_cf_reduced) that Bates
uses, so every quadrature/GL/FFT/IV/AD-Greeks pricer in
:mod:`pde_tpu.models.heston` prices SVCJ with zero new pricing code — the
whole model family costs one NamedTuple.  Monte Carlo overlays
gamma-distributed variance jumps and conditionally-normal price jumps on
the Andersen QE step.  Variance-swap machinery extends through the
maturity-aware ``qv_mean_extra`` hook (the v-jumps raise the forward
variance curve: theta_eff = theta + lam*mu_v/kappa) and a closed-form
integrated-variance Laplace correction.

Reductions (regression-tested): ``mu_v = 0`` recovers
:class:`~pde_tpu.models.bates.BatesParams` exactly; ``lam = 0`` recovers
Heston.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype
from . import heston as heston_model
from .heston import HestonParams
from .heston_mc import MCPaths, _make_qe_step, _qe_constants

__all__ = [
    "SVCJParams",
    "price_carr_madan_gl",
    "price_accurate",
    "price_accurate_grouped",
    "price_fft",
    "implied_volatility",
    "simulate_qe",
    "simulate_qe_paths",
    "simulate_qe_qv",
    "price_european_mc",
    "price_american_mc",
    "price_path_payoff_mc",
]


def _int_recip_affine(c, e, a, b, gamma, T):
    """Closed form of ``INT_0^T (c + e*y) / (a + b*y) ds`` with
    ``y = e^{-gamma s}`` — the primitive every SVCJ time-integrated jump
    transform reduces to (partial fractions in ``y``):

        (c/a) T + (e a - c b) / (a b gamma) * log((a + b) / (a + b e^{-gamma T}))

    ``b -> 0`` (e.g. the u = 0 quadrature node, where the Riccati D
    vanishes) is removable; the guarded branch uses the first-order limit
    ``(e a - c b)/(a b) * log(1 + b(1-y_T)/(a+b y_T)) -> e (1 - y_T) / a``.
    """
    y_T = jnp.exp(-gamma * T)
    small = jnp.abs(b) < 1e-12
    b_safe = jnp.where(small, jnp.ones_like(b), b)
    log_term = (e * a - c * b) / (a * b_safe * gamma) * jnp.log(
        (a + b_safe) / (a + b_safe * y_T)
    )
    limit = e * (1.0 - y_T) / (a * gamma)
    return c / a * T + jnp.where(small, limit, log_term)


class SVCJParams(NamedTuple):
    """SVCJ parameters as a JAX pytree: Heston five plus the co-jump five
    ``(lam, mu_x, sigma_x, mu_v, rho_j)``.

    ``mu_v = 0`` degenerates the variance jump to zero and reduces exactly
    to :class:`~pde_tpu.models.bates.BatesParams` ``(lam, mu_x, sigma_x)``;
    ``lam = 0`` reduces to Heston.
    """

    kappa: jnp.ndarray
    theta: jnp.ndarray
    sigma: jnp.ndarray
    rho: jnp.ndarray
    v0: jnp.ndarray
    lam: jnp.ndarray
    mu_x: jnp.ndarray
    sigma_x: jnp.ndarray
    mu_v: jnp.ndarray
    rho_j: jnp.ndarray

    # -- affine-extension hook (models/heston.py:_cf_reduced) ---------------
    def cf_reduced_extra(self, u, T, rdt, cdt):
        """Time-integrated DPS jump transform, closed form.

        Recomputes the Heston Riccati intermediates (xi, d, g) exactly as
        models/heston.py:_cf_reduced does, writes ``D(s)`` as
        ``beta (1 - y)/(1 - g y)`` with ``y = e^{-d s}``, and reduces
        ``INT 1/(ctil - mu_v D(s)) ds`` to :func:`_int_recip_affine` with
        ``(c, e, a, b) = (1, -g, ctil - mu_v beta, mu_v beta - ctil g)``.
        At ``u = -i`` the exponent vanishes (D = 0, phi_x = 1 + kbar), so
        the factor is 1 and the forward is preserved — the hook's
        martingale contract.
        """
        kappa = jnp.asarray(self.kappa, dtype=rdt)
        sig = jnp.asarray(self.sigma, dtype=rdt)
        rho_ = jnp.asarray(self.rho, dtype=rdt)
        lam = jnp.asarray(self.lam, dtype=rdt)
        mu_x = jnp.asarray(self.mu_x, dtype=rdt)
        s_x = jnp.asarray(self.sigma_x, dtype=rdt)
        mu_v = jnp.asarray(self.mu_v, dtype=rdt)
        rho_j = jnp.asarray(self.rho_j, dtype=rdt)
        i = jnp.asarray(1j, dtype=cdt)

        sigma2 = sig * sig
        xi = kappa - rho_ * sig * i * u
        d = jnp.sqrt(xi * xi + sigma2 * (i * u + u * u))
        g = (xi - d) / (xi + d)
        beta = (xi - d) / sigma2

        ctil = 1.0 - mu_v * rho_j * i * u
        a = ctil - mu_v * beta
        b = mu_v * beta - ctil * g
        I = _int_recip_affine(jnp.ones_like(ctil), -g, a, b, d, T)

        phi_x = jnp.exp(i * u * mu_x - 0.5 * s_x * s_x * u * u)
        kbar = self.mean_jump()
        return jnp.exp(lam * (phi_x * I - T - i * u * kbar * T))

    # -- variance-swap hooks (models/varswap.py) ----------------------------
    def qv_mean_extra(self, T):
        """Jump contribution to the fair variance strike, per unit time:
        the price-jump QV rate ``lam E[Z_x^2]`` plus the v-jump
        feed-through into the forward variance curve
        ``(lam mu_v / kappa)(1 - (1 - e^{-kappa T})/(kappa T))``."""
        ez2 = (self.sigma_x**2 + self.mu_x**2
               + 2.0 * self.mu_x * self.rho_j * self.mu_v
               + 2.0 * (self.rho_j * self.mu_v) ** 2)
        kT = self.kappa * T
        feed = (self.lam * self.mu_v / self.kappa) * (
            1.0 - -jnp.expm1(-kT) / kT
        )
        return self.lam * ez2 + feed

    def qv_log_laplace_extra(self, s, T):
        """log E-correction to the integrated-variance Laplace transform,
        evaluated as the EXACT time-integrated joint jump transform

            lam * INT_0^T ( E[ e^{-s Z_x^2 - Z_v B(s, tau)} ] - 1 ) dtau

        where ``B(s, tau)`` is the CIR Riccati solution.  The price-jump QV
        term ``Z_x^2`` and the v-jump feed-through ``Z_v B`` are driven by
        the SAME Poisson arrival, and ``Z_x | Z_v ~ N(mu_x + rho_j Z_v,
        sigma_x^2)`` — the joint expectation does not factor into the
        product of the two marginal legs.  The inner Gaussian integral is
        closed form (``E[e^{-s X^2}] = e^{-s m^2 / (1 + 2 s sig^2)}
        / sqrt(1 + 2 s sig^2)`` for ``X ~ N(m, sig^2)``), ``Z_v`` is
        integrated by 32-node Gauss-Laguerre, and the outer ``tau``
        integral by 64-node Gauss-Legendre (the integrand is smooth).

        Reductions (regression-tested against MC with both legs live):
        ``mu_v = 0`` recovers the Bates price-jump factor
        ``lam T (E[e^{-s Z_x^2}] - 1)``; ``mu_x = sigma_x = rho_j = 0``
        recovers the pure v-jump leg ``lam (INT 1/(1 + mu_v B) dtau - T)``.
        """
        dt = jnp.result_type(s, T, self.kappa, float)
        s = jnp.asarray(s, dt)
        T = jnp.asarray(T, dt)
        kappa = jnp.asarray(self.kappa, dt)
        sig = jnp.asarray(self.sigma, dt)
        gam = jnp.sqrt(kappa * kappa + 2.0 * sig * sig * s)
        xl, wl = (jnp.asarray(v, dt) for v in _gauss_laguerre(32))
        xg, wg = (jnp.asarray(v, dt) for v in _gauss_legendre(64))
        # tau nodes on [0, T]; broadcast layout (..., n_tau, n_zv)
        tau = 0.5 * T * (xg + 1.0)
        y = jnp.exp(-gam[..., None] * tau)                     # (..., 64)
        B = (2.0 * s[..., None] * (1.0 - y)
             / ((gam[..., None] + kappa) + (gam[..., None] - kappa) * y))
        zv = self.mu_v * xl                                    # Exp(mu_v) nodes
        m = self.mu_x + self.rho_j * zv                        # (32,)
        den = 1.0 + 2.0 * s[..., None] * self.sigma_x**2       # (..., 1)
        phi_x = jnp.exp(-s[..., None] * m * m / den) / jnp.sqrt(den)
        inner = jnp.sum(
            wl * phi_x[..., None, :] * jnp.exp(-zv * B[..., :, None]),
            axis=-1,
        )                                                      # (..., 64)
        integral = 0.5 * T * jnp.sum(wg * inner, axis=-1)
        return self.lam * (integral - T)

    def qv_laplace_extra(self, s, T):
        return jnp.exp(self.qv_log_laplace_extra(s, T))

    # -- reductions / checks -------------------------------------------------
    def heston(self) -> HestonParams:
        return HestonParams(self.kappa, self.theta, self.sigma, self.rho,
                            self.v0)

    def mean_jump(self):
        """kbar = E[e^{Z_x}] - 1 over the co-jump mixture."""
        return (jnp.exp(self.mu_x + 0.5 * self.sigma_x**2)
                / (1.0 - self.rho_j * self.mu_v) - 1.0)

    def feller_value(self):
        return 2.0 * self.kappa * self.theta - self.sigma**2

    def feller_satisfied(self):
        return self.feller_value() > 0

    def validate(self) -> None:
        if float(self.lam) < 0 or float(self.sigma_x) < 0 or float(self.mu_v) < 0:
            raise ValueError("lam, sigma_x, mu_v must be non-negative")
        if float(self.rho_j) * float(self.mu_v) >= 1.0:
            raise ValueError(
                "rho_j * mu_v must be < 1 for a finite jump compensator")
        if not -1.0 < float(self.rho) < 1.0:
            raise ValueError("rho must be in (-1, 1)")

    def to_array(self):
        return jnp.stack([jnp.asarray(v, jnp.result_type(float)) for v in self])

    @classmethod
    def from_array(cls, arr):
        return cls(*arr)


@functools.lru_cache(maxsize=4)
def _gauss_hermite(n: int):
    """Host-cached numpy nodes/weights (numpy, NOT jnp: caching a device
    array created inside a jit trace leaks the tracer)."""
    import numpy as np

    return np.polynomial.hermite.hermgauss(n)


@functools.lru_cache(maxsize=4)
def _gauss_laguerre(n: int):
    import numpy as np

    return np.polynomial.laguerre.laggauss(n)


@functools.lru_cache(maxsize=4)
def _gauss_legendre(n: int):
    import numpy as np

    return np.polynomial.legendre.leggauss(n)


# European pricing / IV: the heston-module pricers dispatch on the
# cf_reduced_extra hook at trace time — SVCJParams plugs straight in
price_carr_madan_gl = heston_model.price_carr_madan_gl
price_carr_madan_gl_grouped = heston_model.price_carr_madan_gl_grouped
price_accurate = heston_model.price_accurate
price_accurate_grouped = heston_model.price_accurate_grouped
price_fft = heston_model.price_fft
implied_volatility = heston_model.implied_volatility
implied_volatility_grouped = heston_model.implied_volatility_grouped


def _jump_overlay(k_t, n_paths, lam_dt, mu_x, sigma_x, mu_v, rho_j, dtype):
    """One step's co-jump draws: (x-jump total, v-jump total) per path.

    ``N ~ Poisson(lam dt)``; the summed v-jump is ``Gamma(N, mu_v)`` (a sum
    of N exponentials) and the summed x-jump given it is
    ``N mu_x + rho_j J_v + sqrt(N) sigma_x Z`` — both exact for any N.
    """
    k_n, k_v, k_z = jax.random.split(k_t, 3)
    n = jax.random.poisson(k_n, lam_dt, (n_paths,)).astype(dtype)
    has = n > 0
    gam = jax.random.gamma(k_v, jnp.where(has, n, 1.0), dtype=dtype)
    jv = jnp.where(has, mu_v * gam, 0.0)
    z = jax.random.normal(k_z, (n_paths,), dtype)
    jx = n * mu_x + rho_j * jv + jnp.sqrt(n) * sigma_x * z
    return jx, jv


def _qe_setup(params, spot, maturity, rate, dividend, n_steps, n_paths,
              antithetic, dtype):
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths
    dt = jnp.asarray(maturity, dtype) / n_steps
    E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(
        params.heston(), dt, dtype)
    kbar = params.mean_jump()
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)
             - jnp.asarray(params.lam, dtype) * kbar) * dt
    return n_draw, dt, (E, c1, c2, jnp.asarray(params.theta, dtype),
                        k0_plain, k1, k2, k3, k4, drift)


@functools.partial(
    jax.jit, static_argnames=("n_steps", "n_paths", "antithetic",
                              "martingale_correction"),
)
def simulate_qe(
    params: SVCJParams, spot, maturity, key, *,
    n_steps: int = 64, n_paths: int = 65536, rate=0.0, dividend=0.0,
    antithetic: bool = True, martingale_correction: bool = True,
) -> MCPaths:
    """SVCJ paths: Andersen QE diffusion + per-step correlated co-jumps.

    The jump overlay bumps BOTH the log-price and the variance inside the
    step scan (models/bates.py:simulate_qe overlays the price only), so
    running average/max/min statistics and every exotic estimator in
    models/heston_mc.py remain valid under co-jumps.
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    n_draw, dt, qe_args = _qe_setup(
        params, spot, maturity, rate, dividend, n_steps, n_paths,
        antithetic, dtype)
    E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift = qe_args
    lam_dt = jnp.asarray(params.lam, dtype) * dt
    mu_x = jnp.asarray(params.mu_x, dtype)
    s_x = jnp.asarray(params.sigma_x, dtype)
    mu_v = jnp.asarray(params.mu_v, dtype)
    rho_j = jnp.asarray(params.rho_j, dtype)

    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
    )
    s0 = jnp.asarray(spot, dtype)
    state0 = (
        jnp.full((n_paths,), jnp.log(s0), dtype),
        jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype),
        jnp.zeros((n_paths,), dtype),
        jnp.full((n_paths,), s0, dtype),
        jnp.full((n_paths,), s0, dtype),
    )

    def step(state, k_t):
        ln_s, v, s_sum, s_max, s_min = state
        k_diff, k_jump = jax.random.split(k_t)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        jx, jv = _jump_overlay(k_jump, n_paths, lam_dt, mu_x, s_x, mu_v,
                               rho_j, dtype)
        ln_s_new = ln_s_new + jx
        v_new = v_new + jv
        s = jnp.exp(ln_s_new)
        return (
            ln_s_new, v_new, s_sum + s,
            jnp.maximum(s_max, s), jnp.minimum(s_min, s),
        ), None

    (ln_s, v, s_sum, s_max, s_min), _ = jax.lax.scan(
        step, state0, jax.random.split(key, n_steps))
    return MCPaths(jnp.exp(ln_s), v, s_sum / n_steps, s_max, s_min)


@functools.partial(
    jax.jit, static_argnames=("n_steps", "n_paths", "antithetic",
                              "martingale_correction"),
)
def simulate_qe_paths(
    params: SVCJParams, spot, maturity, key, *,
    n_steps: int = 64, n_paths: int = 65536, rate=0.0, dividend=0.0,
    antithetic: bool = True, martingale_correction: bool = True,
):
    """Stored-path SVCJ simulation ``(S, v)`` of shape ``(n_steps,
    n_paths)`` — feeds Longstaff-Schwarz American exercise under co-jump
    risk through the ``simulate_paths_fn`` seam in solvers.lsm."""
    dtype = result_dtype(spot, maturity, params.kappa)
    n_draw, dt, qe_args = _qe_setup(
        params, spot, maturity, rate, dividend, n_steps, n_paths,
        antithetic, dtype)
    E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift = qe_args
    lam_dt = jnp.asarray(params.lam, dtype) * dt
    mu_x = jnp.asarray(params.mu_x, dtype)
    s_x = jnp.asarray(params.sigma_x, dtype)
    mu_v = jnp.asarray(params.mu_v, dtype)
    rho_j = jnp.asarray(params.rho_j, dtype)

    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
    )
    ln_s0 = jnp.full((n_paths,), jnp.log(jnp.asarray(spot, dtype)), dtype)
    v0 = jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype)

    def step(state, k_t):
        ln_s, v = state
        k_diff, k_jump = jax.random.split(k_t)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        jx, jv = _jump_overlay(k_jump, n_paths, lam_dt, mu_x, s_x, mu_v,
                               rho_j, dtype)
        ln_s_new = ln_s_new + jx
        v_new = v_new + jv
        return (ln_s_new, v_new), (ln_s_new, v_new)

    _, (ln_s_path, v_path) = jax.lax.scan(
        step, (ln_s0, v0), jax.random.split(key, n_steps))
    return jnp.exp(ln_s_path), v_path


@functools.partial(jax.jit, static_argnames=("n_steps", "n_paths",
                                             "antithetic",
                                             "martingale_correction"))
def simulate_qe_qv(
    params: SVCJParams, spot, maturity, key, *,
    n_steps: int = 64, n_paths: int = 65536, rate=0.0, dividend=0.0,
    antithetic: bool = True, martingale_correction: bool = True,
):
    """Per-path realized quadratic variation ``(int_0^T v dt, sum Z_x^2)``.

    The MC oracle for the variance-swap transform hooks with BOTH co-jump
    legs live: the continuous leg is a trapezoidal Riemann sum of the
    variance path (which the v-jumps feed), the jump leg accumulates the
    squared per-step price-jump total.  With at most one arrival per step
    almost surely, ``jx^2`` equals the per-jump sum of squares up to an
    ``O((lam dt)^2)`` collision bias — refine ``n_steps`` below tolerance.
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    n_draw, dt, qe_args = _qe_setup(
        params, spot, maturity, rate, dividend, n_steps, n_paths,
        antithetic, dtype)
    E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift = qe_args
    lam_dt = jnp.asarray(params.lam, dtype) * dt
    mu_x = jnp.asarray(params.mu_x, dtype)
    s_x = jnp.asarray(params.sigma_x, dtype)
    mu_v = jnp.asarray(params.mu_v, dtype)
    rho_j = jnp.asarray(params.rho_j, dtype)
    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
    )
    ln_s0 = jnp.full((n_paths,), jnp.log(jnp.asarray(spot, dtype)), dtype)
    v0 = jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype)
    zero = jnp.zeros((n_paths,), dtype)

    def step(state, k_t):
        ln_s, v, iv, qj = state
        k_diff, k_jump = jax.random.split(k_t)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        jx, jv = _jump_overlay(k_jump, n_paths, lam_dt, mu_x, s_x, mu_v,
                               rho_j, dtype)
        # trapezoid on the diffused (pre-jump) endpoint: the jump lands at
        # the step boundary and contributes to the NEXT interval's integrand
        iv = iv + 0.5 * (v + v_new) * dt
        qj = qj + jx * jx
        return (ln_s_new + jx, v_new + jv, iv, qj), None

    (_, _, iv, qj), _ = jax.lax.scan(
        step, (ln_s0, v0, zero, zero), jax.random.split(key, n_steps))
    return iv, qj


def price_european_mc(params: SVCJParams, strikes, maturity, spot, key,
                      **kwargs):
    """European vanillas under SVCJ via the QE + co-jump engine.  Returns
    ``(price, stderr)`` shaped like ``strikes``; cross-validates the CF
    hook (tests/test_svcj.py)."""
    from . import heston_mc

    return heston_mc.price_european_mc(
        params, strikes, maturity, spot, key,
        simulate_fn=simulate_qe, **kwargs,
    )


def price_american_mc(params: SVCJParams, strike, maturity, spot, key,
                      **kwargs):
    """American vanilla under SVCJ via Longstaff-Schwartz on the co-jump
    paths; returns ``(price, stderr)``."""
    from ..solvers import lsm

    return lsm.price_american_lsm(
        params, strike, maturity, spot, key,
        simulate_paths_fn=simulate_qe_paths, **kwargs,
    )


def price_path_payoff_mc(params: SVCJParams, payoff_fn, spot, maturity, key,
                         **kwargs):
    """Generic path-payoff estimator under SVCJ (Asian/lookback/custom) —
    heston_mc's estimator machinery over :func:`simulate_qe`."""
    from . import heston_mc

    return heston_mc.price_path_payoff_mc(
        params, payoff_fn, spot, maturity, key,
        simulate_fn=simulate_qe, **kwargs,
    )
