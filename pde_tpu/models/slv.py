"""Stochastic-local volatility (SLV): Heston dynamics x Dupire leverage.

The industry-standard smile model the reference lacks entirely:

    dS/S = (r - q) dt + L(S, t) sqrt(v) dW_S
    dv   = kappa (theta - v) dt + sigma sqrt(v) dW_v,  d<W_S,W_v> = rho dt

with the **leverage function** L chosen so vanillas match a target
local-vol surface.  Gyongy's theorem gives the calibration condition

    L^2(s, t) * E[v_t | S_t = s] = sigma_loc^2(s, t)

which the **particle method** (Guyon & Henry-Labordere 2012) solves in one
forward sweep: march a particle cloud, estimate E[v | S] at each step by
binning (a `segment_sum` — fixed bin count, static shapes, accelerator-friendly),
set L from the target surface, step with it, repeat.  The whole calibration
is one `lax.scan`.

The spot update generalizes the Andersen QE scheme: decomposing the QE
coefficients into their rho-coupled (one power of the Brownian exposure)
and variance-compensator parts lets leverage enter as L and L^2 exactly,
and Andersen's K0* martingale correction generalizes to a **per-particle**
correction (the branch algebra is unchanged with per-particle effective
coefficients A, B), so the discounted spot is a discrete martingale for
ANY leverage function — no empirical drift fix needed.

Validation (tests/test_slv.py): with mixed dynamics (vol-of-vol halved),
the leverage-calibrated SLV re-prices the TARGET model's vanillas; at
sigma -> 0 it degenerates to pure local vol; with the target equal to the
model's own Dupire surface, L ~ 1.

Discretization bias (measured, mixed-dynamics T=0.75 validation): the
repricing error vs the target CF is ~0.6% ATM / ~1.8% at 110% moneyness /
~4% at 120% with (32 steps, 25 bins, 65k particles), falling to ~0.7% /
1.7% / 3.1% at (64, 41, 131k) — refine steps/bins for wing-sensitive books.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype
from .heston import HestonParams
from .heston_mc import (
    _TINY,
    PSI_CRIT,
    MCPaths,
    _qe_constants,
    _qe_variance_draw,
)

__all__ = [
    "LeverageSurface",
    "calibrate_leverage",
    "simulate_slv",
    "slv_simulate_fn",
]


class LeverageSurface(NamedTuple):
    """Calibrated leverage on a fixed (time-step, ln-spot-bin) grid."""

    ln_s_centers: jnp.ndarray   # (n_bins,)
    times: jnp.ndarray          # (n_steps,) left endpoints t_k
    values: jnp.ndarray         # (n_steps, n_bins)


def _slv_coeffs(params: HestonParams, dt, dtype):
    """QE spot-update coefficients split by leverage power.

    The plain QE exponent  K0 + K1 v + K2 v' + sqrt(K3 v + K4 v') Z
    decomposes into a rho-coupled part (scales with L) and the variance
    compensator (-1/2 int L^2 v dt, scales with L^2):

        ln S' = ln S + (r-q) dt
                + L   * (k0r + k1r v + k2r v')
                + L^2 * (k1v v + k2v v')
                + L   * sqrt(k3 v + k4 v') Z

    At L = 1 this is bit-for-bit Andersen's central scheme.
    """
    kappa = jnp.asarray(params.kappa, dtype)
    theta = jnp.asarray(params.theta, dtype)
    sigma = jnp.asarray(params.sigma, dtype)
    rho = jnp.asarray(params.rho, dtype)
    g1 = g2 = 0.5
    k0r = -rho * kappa * theta * dt / sigma
    k1r = g1 * dt * kappa * rho / sigma - rho / sigma
    k2r = g2 * dt * kappa * rho / sigma + rho / sigma
    k1v = -0.5 * g1 * dt
    k2v = -0.5 * g2 * dt
    k3 = g1 * dt * (1.0 - rho * rho)
    k4 = g2 * dt * (1.0 - rho * rho)
    return k0r, k1r, k2r, k1v, k2v, k3, k4


def _k0_star_leveraged(v, a, b2, p, beta, is_quad, A, B):
    """Andersen's K0* with per-particle effective coefficients.

    A is the total coefficient of v' in the moment-generating exponent
    (L k2r + L^2 (k2v + k4/2)), B the coefficient of v
    (L k1r + L^2 (k1v + k3/2)); the branch algebra (Andersen eqs. 37-40)
    is unchanged — it only ever sees A — so exact martingality holds
    per particle for any leverage."""
    one_m2Aa = jnp.maximum(1.0 - 2.0 * A * a, _TINY)
    k0_quad = -A * b2 * a / one_m2Aa + 0.5 * jnp.log(one_m2Aa)
    beta_mA = jnp.maximum(beta - A, _TINY)
    k0_exp = -jnp.log(jnp.maximum(p + beta * (1.0 - p) / beta_mA, _TINY))
    return jnp.where(is_quad, k0_quad, k0_exp) - B * v


def _make_slv_step(params, dt, n_draw, antithetic, dtype, drift):
    """(ln_s, v, L_particles, key) -> (ln_s', v') with exact per-particle
    martingale correction."""
    E, c1, c2, _k0, _k1, _k2, _k3, _k4 = _qe_constants(params, dt, dtype)
    theta = jnp.asarray(params.theta, dtype)
    k0r, k1r, k2r, k1v, k2v, k3, k4 = _slv_coeffs(params, dt, dtype)

    def step(ln_s, v, L, k_t):
        k_u, k_z = jax.random.split(k_t)
        u = jax.random.uniform(k_u, (n_draw,), dtype)
        z = jax.random.normal(k_z, (n_draw,), dtype)
        if antithetic:
            u = jnp.concatenate([u, 1.0 - u])
            z = jnp.concatenate([z, -z])
        v_new, a, b2, p, beta, is_quad = _qe_variance_draw(
            v, u, E, c1, c2, theta, PSI_CRIT, dtype)
        L2 = L * L
        A = L * k2r + L2 * (k2v + 0.5 * k4)
        B = L * k1r + L2 * (k1v + 0.5 * k3)
        k0 = _k0_star_leveraged(v, a, b2, p, beta, is_quad, A, B)
        vol = L * jnp.sqrt(jnp.maximum(k3 * v + k4 * v_new, 0.0))
        ln_s_new = (ln_s + drift + k0 + L * (k1r * v + k2r * v_new)
                    + L2 * (k1v * v + k2v * v_new) + vol * z)
        return ln_s_new, v_new

    return step


def _bin_expectation(ln_s, v, edges, n_bins, min_count=8, axis_name=None):
    """E[v | S in bin] by masked segment mean; thin bins fall back to the
    global mean (they carry negligible leverage-pricing weight).

    With ``axis_name`` the bin sums are ``psum``-reduced over a sharded
    path axis, so every device sees the GLOBAL conditional expectation —
    the distributed particle method costs one fused psum of ~2*n_bins
    scalars per step (parallel/mc.py:calibrate_leverage_sharded)."""
    idx = jnp.clip(jnp.searchsorted(edges, ln_s) - 1, 0, n_bins - 1)
    ones = jnp.ones_like(v)
    counts = jax.ops.segment_sum(ones, idx, num_segments=n_bins)
    sums = jax.ops.segment_sum(v, idx, num_segments=n_bins)
    v_sum = jnp.sum(v)
    n_tot = jnp.asarray(v.shape[0], v.dtype)
    if axis_name is not None:
        counts = jax.lax.psum(counts, axis_name)
        sums = jax.lax.psum(sums, axis_name)
        v_sum = jax.lax.psum(v_sum, axis_name)
        n_tot = jax.lax.psum(n_tot, axis_name)
    ev = sums / jnp.maximum(counts, 1.0)
    return jnp.where(counts >= min_count, ev, v_sum / n_tot), idx


def calibrate_leverage(
    params: HestonParams,
    vol_fn,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 48,
    n_paths: int = 65536,
    n_bins: int = 31,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    span_sigmas: float = 4.5,
    l_min: float = 0.05,
    l_max: float = 20.0,
    axis_name: str | None = None,
):
    """One-sweep particle calibration of the leverage surface to the target
    local vol ``vol_fn(s_array, t) -> sigma_loc`` (e.g. a
    :class:`~pde_tpu.models.local_vol.SurfaceInterpolator`).

    Returns ``(LeverageSurface, MCPaths)`` — the calibration sweep is
    itself a valid simulation under the calibrated model, so its terminal
    cloud prices vanillas for validation at zero extra cost.  Not jitted at
    the top level (``vol_fn`` is a closure); wrap callers in ``jax.jit``.
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    T = jnp.asarray(maturity, dtype)
    dt = T / n_steps
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)) * dt
    s0 = jnp.asarray(spot, dtype)
    vbar = jnp.maximum(jnp.asarray(params.theta, dtype),
                       jnp.asarray(params.v0, dtype))
    half_span = span_sigmas * jnp.sqrt(vbar * T)
    center = jnp.log(s0) + 0.5 * (jnp.asarray(rate, dtype)
                                  - jnp.asarray(dividend, dtype)) * T
    edges = jnp.linspace(center - half_span, center + half_span, n_bins + 1)
    centers = 0.5 * (edges[1:] + edges[:-1])
    s_centers = jnp.exp(centers)

    slv_step = _make_slv_step(params, dt, n_draw, antithetic, dtype, drift)

    state0 = (
        jnp.full((n_paths,), jnp.log(s0), dtype),
        jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype),
        jnp.zeros((n_paths,), dtype),
        jnp.full((n_paths,), s0, dtype),
        jnp.full((n_paths,), s0, dtype),
    )
    times = dt * jnp.arange(n_steps, dtype=dtype)

    def body(state, inp):
        ln_s, v, s_sum, s_max, s_min = state
        t_k, k_t = inp
        ev, idx = _bin_expectation(ln_s, v, edges, n_bins,
                                   axis_name=axis_name)
        # midpoint time evaluation of the target: measurably less
        # discretization bias than the left point (wing error ~-15% at
        # 32 steps in the mixed-dynamics validation)
        sig_loc = vol_fn(s_centers, t_k + 0.5 * dt)
        L_bins = jnp.clip(
            sig_loc / jnp.sqrt(jnp.maximum(ev, _TINY)), l_min, l_max)
        L = jnp.interp(ln_s, centers, L_bins)
        ln_s, v = slv_step(ln_s, v, L, k_t)
        s = jnp.exp(ln_s)
        return (ln_s, v, s_sum + s, jnp.maximum(s_max, s),
                jnp.minimum(s_min, s)), L_bins

    keys = jax.random.split(key, n_steps)
    (ln_s, v, s_sum, s_max, s_min), L_rows = jax.lax.scan(
        body, state0, (times, keys))
    surface = LeverageSurface(centers, times, L_rows)
    paths = MCPaths(jnp.exp(ln_s), v, s_sum / n_steps, s_max, s_min)
    return surface, paths


def simulate_slv(
    params: HestonParams,
    leverage: LeverageSurface,
    spot,
    maturity,
    key,
    *,
    n_steps: int | None = None,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
):
    """Re-simulate under a FROZEN calibrated leverage surface (fresh
    randoms) — the pricing pass for exotics.  ``n_steps`` must match the
    calibration grid (row-per-step lookup); defaults to it."""
    dtype = result_dtype(spot, maturity, params.kappa)
    rows = leverage.values.shape[0]
    if n_steps is None:
        n_steps = rows
    if n_steps != rows:
        raise ValueError(f"n_steps={n_steps} != calibrated rows={rows}")
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    T = jnp.asarray(maturity, dtype)
    dt = T / n_steps
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)) * dt
    s0 = jnp.asarray(spot, dtype)
    slv_step = _make_slv_step(params, dt, n_draw, antithetic, dtype, drift)
    centers = leverage.ln_s_centers

    state0 = (
        jnp.full((n_paths,), jnp.log(s0), dtype),
        jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype),
        jnp.zeros((n_paths,), dtype),
        jnp.full((n_paths,), s0, dtype),
        jnp.full((n_paths,), s0, dtype),
    )

    def body(state, inp):
        ln_s, v, s_sum, s_max, s_min = state
        L_bins, k_t = inp
        L = jnp.interp(ln_s, centers, L_bins)
        ln_s, v = slv_step(ln_s, v, L, k_t)
        s = jnp.exp(ln_s)
        return (ln_s, v, s_sum + s, jnp.maximum(s_max, s),
                jnp.minimum(s_min, s)), None

    keys = jax.random.split(key, n_steps)
    (ln_s, v, s_sum, s_max, s_min), _ = jax.lax.scan(
        body, state0, (leverage.values, keys))
    return MCPaths(jnp.exp(ln_s), v, s_sum / n_steps, s_max, s_min)


def slv_simulate_fn(leverage: LeverageSurface):
    """Adapter: drop-in ``simulate_fn`` for the heston_mc estimators —
    Asian/barrier/lookback and the control-variate machinery price under
    the calibrated SLV dynamics (the params pytree passes through)."""
    def fn(params, spot, maturity, key, **kwargs):
        kwargs.pop("n_steps", None)  # pinned to the calibration grid
        return simulate_slv(params, leverage, spot, maturity, key, **kwargs)
    return fn
