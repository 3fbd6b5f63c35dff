"""Bates (1996) stochastic-volatility jump-diffusion model.

Heston dynamics plus lognormal Merton-style jumps:

    dS/S = (r - q - lambda * kbar) dt + sqrt(v) dW_S + (e^J - 1) dN
    dv   = kappa (theta - v) dt + sigma sqrt(v) dW_v,   d<W_S, W_v> = rho dt

with ``N`` a Poisson process of intensity ``lambda`` and jump sizes
``J = ln(1 + jump)`` i.i.d. ``N(mu_j, sigma_j^2)``; the compensator
``kbar = E[e^J] - 1 = exp(mu_j + sigma_j^2 / 2) - 1`` keeps the discounted
spot a martingale.

This model family is **beyond the reference** (dharvpat/PDE ships only
Heston / SABR / OU, src/cpp/models/); it exists here to demonstrate — and
test — the framework's affine-extension seam: because jumps enter the
characteristic function as a multiplicative factor that is 1 at ``u = -i``,
:class:`BatesParams` plugs into EVERY pricer in :mod:`pde_tpu.models.heston`
(exact-parity quadrature, corrected Gauss-Legendre, grouped-CF, FFT, implied
vol, AD Greeks) through the ``cf_reduced_extra`` hook
(models/heston.py:_cf_reduced) with zero new quadrature code.  Monte Carlo
reuses the Andersen QE variance/diffusion step (models/heston_mc.py) with a
per-step compound-Poisson overlay, so the exotic payoff estimators
(Asian/barrier/lookback) price under jumps too.
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
    "BatesParams",
    "price_carr_madan_gl",
    "price_carr_madan_gl_grouped",
    "price_accurate",
    "price_accurate_grouped",
    "price_fft",
    "implied_volatility",
    "implied_volatility_grouped",
    "simulate_qe",
    "price_european_mc",
    "price_path_payoff_mc",
    "merton_reference_price",
]


class BatesParams(NamedTuple):
    """Bates parameters as a JAX pytree: Heston five plus (lam, mu_j, sigma_j).

    ``lam`` is the jump intensity (jumps/year), ``mu_j`` and ``sigma_j`` the
    mean and standard deviation of the log jump size ``ln(1 + jump)``.
    ``lam = 0`` reduces exactly to :class:`~pde_tpu.models.heston.HestonParams`
    semantics (regression-tested in tests/test_bates.py).
    """

    kappa: jnp.ndarray
    theta: jnp.ndarray
    sigma: jnp.ndarray
    rho: jnp.ndarray
    v0: jnp.ndarray
    lam: jnp.ndarray
    mu_j: jnp.ndarray
    sigma_j: jnp.ndarray

    # -- affine-extension hook (consumed by heston._cf_reduced and
    #    heston.characteristic_function at trace time) ----------------------
    def cf_reduced_extra(self, u, T, rdt, cdt):
        """Compensated jump CF factor exp(lam*T*(Phi_J(u) - 1) - i*u*lam*kbar*T).

        ``Phi_J(u) = exp(i u mu_j - u^2 sigma_j^2 / 2)`` is the CF of one log
        jump.  At ``u = -i`` the exponent is ``lam*T*kbar - lam*T*kbar = 0``,
        so the factor is 1 and the forward is preserved — the contract the
        hook requires (models/heston.py:_cf_reduced).
        """
        lam = jnp.asarray(self.lam, dtype=rdt)
        mu_j = jnp.asarray(self.mu_j, dtype=rdt)
        sj = jnp.asarray(self.sigma_j, dtype=rdt)
        i = jnp.asarray(1j, dtype=cdt)
        kbar = jnp.exp(mu_j + 0.5 * sj * sj) - 1.0
        phi_j = jnp.exp(i * u * mu_j - 0.5 * (u * u) * (sj * sj))
        return jnp.exp(lam * T * (phi_j - 1.0) - i * u * (lam * kbar) * T)

    # -- quadratic-variation hooks (consumed by models/varswap.py) ----------
    def qv_rate_extra(self):
        """Expected jump quadratic variation per year: lam * E[J^2]
        = lam * (mu_j^2 + sigma_j^2).  Adds to the variance-swap strike."""
        mu_j = jnp.asarray(self.mu_j)
        sj = jnp.asarray(self.sigma_j)
        return jnp.asarray(self.lam) * (mu_j * mu_j + sj * sj)

    def qv_laplace_extra(self, s, T):
        """Laplace transform of the jump QV sum_{k<=N_T} J_k^2: the compound
        Poisson exp(lam T (E[e^{-s J^2}] - 1)) with the Gaussian-square
        transform E[e^{-s J^2}] = exp(-s mu_j^2/(1+2 s sigma_j^2)) /
        sqrt(1 + 2 s sigma_j^2).  Independent of the diffusion, so it
        multiplies the CIR factor in varswap.integrated_variance_laplace."""
        lam = jnp.asarray(self.lam, dtype=jnp.asarray(s).dtype)
        mu_j = jnp.asarray(self.mu_j, dtype=jnp.asarray(s).dtype)
        sj = jnp.asarray(self.sigma_j, dtype=jnp.asarray(s).dtype)
        denom = 1.0 + 2.0 * s * sj * sj
        ej2 = jnp.exp(-s * mu_j * mu_j / denom) / jnp.sqrt(denom)
        return jnp.exp(lam * T * (ej2 - 1.0))

    def qv_log_laplace_extra(self, s, T):
        """log of :meth:`qv_laplace_extra`, with ``E[e^{-s J^2}] - 1`` formed
        via ``expm1`` so the s -> 0 limit (-s lam T E[J^2]) keeps full
        precision in float32 — consumed by the Schuerger vol-swap/VIX
        quadratures (varswap.integrated_variance_log_laplace)."""
        lam = jnp.asarray(self.lam, dtype=jnp.asarray(s).dtype)
        mu_j = jnp.asarray(self.mu_j, dtype=jnp.asarray(s).dtype)
        sj = jnp.asarray(self.sigma_j, dtype=jnp.asarray(s).dtype)
        q = 2.0 * s * sj * sj
        log_ej2 = -s * mu_j * mu_j / (1.0 + q) - 0.5 * jnp.log1p(q)
        return lam * T * jnp.expm1(log_ej2)

    # -- conveniences --------------------------------------------------------
    def heston(self) -> HestonParams:
        """The diffusion part (drops the jump parameters)."""
        return HestonParams(self.kappa, self.theta, self.sigma, self.rho, self.v0)

    @property
    def mean_jump(self):
        """kbar = E[e^J] - 1, the expected relative jump size."""
        return jnp.exp(jnp.asarray(self.mu_j) + 0.5 * jnp.asarray(self.sigma_j) ** 2) - 1.0

    def feller_value(self):
        return 2.0 * self.kappa * self.theta - self.sigma**2

    def feller_satisfied(self):
        return self.feller_value() >= 0.0

    def validate(self) -> None:
        """Eager host-side validation (style of HestonParams.validate)."""
        import numpy as np

        self.heston().validate()
        lam, sj = np.asarray(self.lam), np.asarray(self.sigma_j)
        if np.any(lam < 0):
            raise ValueError("jump intensity lam must be non-negative")
        if np.any(sj <= 0):
            raise ValueError("jump volatility sigma_j must be positive")

    def to_array(self):
        return jnp.stack(jnp.broadcast_arrays(*map(jnp.asarray, self)), axis=-1)

    @classmethod
    def from_array(cls, arr):
        return cls(*(arr[..., i] for i in range(8)))


# -- pricing: the heston-module pricers accept BatesParams directly through
#    the cf_reduced_extra hook; re-export the main entry points under this
#    module's name so call sites read naturally. ------------------------------
price_carr_madan_gl = heston_model.price_carr_madan_gl
price_carr_madan_gl_grouped = heston_model.price_carr_madan_gl_grouped
price_accurate = heston_model.price_accurate
price_accurate_grouped = heston_model.price_accurate_grouped
price_fft = heston_model.price_fft
implied_volatility = heston_model.implied_volatility
implied_volatility_grouped = heston_model.implied_volatility_grouped


# -- Monte Carlo: QE diffusion + per-step compound-Poisson jump overlay ------

@functools.partial(
    jax.jit, static_argnames=("n_steps", "n_paths", "antithetic",
                              "martingale_correction"),
)
def simulate_qe(
    params: BatesParams,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 64,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    martingale_correction: bool = True,
) -> MCPaths:
    """Simulate Bates paths: Andersen QE for (ln S, v) plus jumps.

    Per step the log-price gains ``sum_{k<=N_t} J_k`` with
    ``N_t ~ Poisson(lam dt)`` — drawn as ``N_t mu_j + sqrt(N_t) sigma_j Z``
    (exact: a sum of ``N_t`` i.i.d. normals) — while the diffusion drift
    carries the ``-lam kbar dt`` compensator.  Jumps land inside the step
    scan, so running average/max/min statistics see them and the exotic
    payoff estimators in models/heston_mc.py remain valid under jumps.

    Antithetic mirroring applies to the diffusion draws only; jump counts
    and sizes are i.i.d. across all ``n_paths`` (mirroring a Poisson count
    has no variance-reduction analog).
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    dt = jnp.asarray(maturity, dtype) / n_steps
    diffusion = params.heston()
    E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(diffusion, dt, dtype)
    theta = jnp.asarray(params.theta, dtype)
    lam = jnp.asarray(params.lam, dtype)
    mu_j = jnp.asarray(params.mu_j, dtype)
    sigma_j = jnp.asarray(params.sigma_j, dtype)
    kbar = jnp.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    drift = (
        jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype) - lam * kbar
    ) * dt

    s0 = jnp.asarray(spot, dtype)
    ln_s0 = jnp.log(s0)
    state0 = (
        jnp.full((n_paths,), ln_s0, dtype),
        jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype),
        jnp.zeros((n_paths,), dtype),
        jnp.full((n_paths,), s0, dtype),
        jnp.full((n_paths,), s0, dtype),
    )
    step_keys = jax.random.split(key, n_steps)

    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
    )
    def step(state, k_t):
        ln_s, v, s_sum, s_max, s_min = state
        k_diff, k_n, k_j = jax.random.split(k_t, 3)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        n_jumps = jax.random.poisson(k_n, lam * dt, (n_paths,)).astype(dtype)
        z_j = jax.random.normal(k_j, (n_paths,), dtype)
        ln_s_new = ln_s_new + n_jumps * mu_j + jnp.sqrt(n_jumps) * sigma_j * z_j
        s = jnp.exp(ln_s_new)
        return (
            ln_s_new,
            v_new,
            s_sum + s,
            jnp.maximum(s_max, s),
            jnp.minimum(s_min, s),
        ), None

    (ln_s, v, s_sum, s_max, s_min), _ = jax.lax.scan(step, state0, step_keys)
    return MCPaths(jnp.exp(ln_s), v, s_sum / n_steps, s_max, s_min)


@functools.partial(
    jax.jit, static_argnames=("n_steps", "n_paths", "antithetic",
                              "martingale_correction"),
)
def simulate_qe_paths(
    params: BatesParams,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 64,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    martingale_correction: bool = True,
):
    """Full stored-path Bates simulation: ``(S, v)`` with shape
    ``(n_steps, n_paths)`` at t_1..t_N (t_0 deterministic, not stored).

    The jump-overlay twin of
    :func:`pde_tpu.models.heston_mc.simulate_qe_paths`; feeds
    backward-induction algorithms — American exercise under jumps via
    :func:`pde_tpu.solvers.lsm.price_american_lsm` with
    ``simulate_paths_fn=``this.
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    dt = jnp.asarray(maturity, dtype) / n_steps
    diffusion = params.heston()
    E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(diffusion, dt, dtype)
    theta = jnp.asarray(params.theta, dtype)
    lam = jnp.asarray(params.lam, dtype)
    mu_j = jnp.asarray(params.mu_j, dtype)
    sigma_j = jnp.asarray(params.sigma_j, dtype)
    kbar = jnp.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    drift = (
        jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype) - lam * kbar
    ) * dt

    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
    )
    ln_s0 = jnp.full((n_paths,), jnp.log(jnp.asarray(spot, dtype)), dtype)
    v0 = jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype)

    def step(state, k_t):
        ln_s, v = state
        k_diff, k_n, k_j = jax.random.split(k_t, 3)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        n_jumps = jax.random.poisson(k_n, lam * dt, (n_paths,)).astype(dtype)
        z_j = jax.random.normal(k_j, (n_paths,), dtype)
        ln_s_new = ln_s_new + n_jumps * mu_j + jnp.sqrt(n_jumps) * sigma_j * z_j
        return (ln_s_new, v_new), (ln_s_new, v_new)

    _, (ln_s_path, v_path) = jax.lax.scan(
        step, (ln_s0, v0), jax.random.split(key, n_steps)
    )
    return jnp.exp(ln_s_path), v_path


def price_american_mc(params: BatesParams, strike, maturity, spot, key,
                      **kwargs):
    """American vanilla under Bates via Longstaff-Schwartz on the
    jump-overlay paths.  Returns ``(price, stderr)`` — early exercise under
    jump risk, unreachable by the CF pricers and (without a PIDE solver)
    by the grid methods."""
    from ..solvers import lsm

    return lsm.price_american_lsm(
        params, strike, maturity, spot, key,
        simulate_paths_fn=simulate_qe_paths, **kwargs,
    )


def price_path_payoff_mc(params: BatesParams, payoff_fn, spot, maturity, key,
                         **kwargs):
    """Bates path-payoff pricing: heston_mc's estimator machinery (control
    variate, antithetic pair-folding) over :func:`simulate_qe`."""
    from . import heston_mc

    return heston_mc.price_path_payoff_mc(
        params, payoff_fn, spot, maturity, key,
        simulate_fn=simulate_qe, **kwargs,
    )


def price_european_mc(params: BatesParams, strikes, maturity, spot, key,
                      **kwargs):
    """European vanilla under Bates via QE + jump overlay MC.  Returns
    (price, stderr) shaped like ``strikes``; cross-validates the CF pricers
    (tests/test_bates.py)."""
    from . import heston_mc

    return heston_mc.price_european_mc(
        params, strikes, maturity, spot, key,
        simulate_fn=simulate_qe, **kwargs,
    )


def merton_reference_price(
    strike, maturity, spot, rate, dividend, bs_vol, lam, mu_j, sigma_j,
    is_call=True, n_terms=40,
):
    """Merton (1976) jump-diffusion series price — an independent float64
    oracle for the jump machinery (pure numpy, no JAX).

    Conditioning on ``n`` jumps, the price is a Poisson-weighted sum of
    Black-Scholes prices with adjusted rate and variance.  With the Heston
    diffusion degenerate (``sigma -> 0``, ``v0 = theta = bs_vol^2``) the
    Bates CF price must match this series; tests/test_bates.py asserts it.
    """
    import numpy as np
    from scipy.stats import norm

    strike = np.asarray(strike, dtype=np.float64)
    tau = float(maturity)
    kbar = np.exp(mu_j + 0.5 * sigma_j**2) - 1.0
    lamp = lam * (1.0 + kbar)  # lambda' of the Merton series
    total = np.zeros_like(strike, dtype=np.float64)
    log_pn = -lamp * tau  # log Poisson(lambda' tau) weight, n = 0
    for n in range(n_terms):
        if n > 0:
            log_pn += np.log(lamp * tau) - np.log(n)
        sig_n = np.sqrt(bs_vol**2 + n * sigma_j**2 / tau)
        r_n = rate - lam * kbar + n * (mu_j + 0.5 * sigma_j**2) / tau
        # plain Black-Scholes at (r_n, sig_n) — r_n replaces r everywhere,
        # including the discount (Merton 1976, Eq. 19)
        sqt = sig_n * np.sqrt(tau)
        d1 = (np.log(spot / strike) + (r_n - dividend + 0.5 * sig_n**2) * tau) / sqt
        d2 = d1 - sqt
        call = (spot * np.exp(-dividend * tau) * norm.cdf(d1)
                - strike * np.exp(-r_n * tau) * norm.cdf(d2))
        if not is_call:
            call = (call - spot * np.exp(-dividend * tau)
                    + strike * np.exp(-r_n * tau))
        total += np.exp(log_pn) * call
    return total
