"""Bates 2D PIDE solver — Douglas ADI + IMEX-CNAB jump term.

American and European options under stochastic volatility WITH jumps: the
Heston operator of :mod:`pde_tpu.solvers.heston_adi` (same In 't Hout-Foulon
boundary treatment, same batched-Thomas sweeps) extended with the Bates
non-local term

    lam * INT V(x + y, v) nu(y) dy  -  lam * V  -  lam * kbar * V_x

where ``nu`` is the log-jump density (lognormal :class:`MertonJumps` — the
Bates 1996 model — or double-exponential :class:`KouJumps` for an SVJ-Kou
variant).  The reference framework prices under jumps only through the Bates
characteristic function (European quadrature); it has **no** PDE/PIDE route
and therefore no American-under-jumps solver at all — this module is that
missing rigorous route, and its European limit is cross-validated against
the CF pricer (models/bates.py) in tests/test_bates_pide.py.

Device shape of the jump term: the density is v-independent and acts along the
log-spot axis only, so on the uniform x grid the integral over ALL nv
variance columns is ONE Toeplitz contraction ``W @ V`` with ``W`` of shape
``(nS, nS)`` and ``V`` of shape ``(nS, nv)`` — a single matmul per
explicit pass (a CPU design pays nv independent O(nS^2) loops or FFTs).
Jump mass beyond the grid edges integrates in closed form against the
payoff asymptote exactly as in the 1D solver (solvers/pide.py).

Time stepping follows the IMEX-CNAB family of Salmi, Toivanen & von Sydow
(2014): the local Heston operator marches with the Douglas splitting
(implicit sweeps, factored once) while the jump integral enters explicitly
with second-order Adams-Bashforth extrapolation ``1.5 J V^n - 0.5 J V^{n-1}``
(plain Euler on the first step).  The explicit treatment is stable because
``||J|| <= lam`` and ``lam * dt`` is small for any sane grid.  American
exercise: per-step projection or Ikonen-Toivanen splitting, as in the
diffusion-only solver.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import grids
from ..ops.tridiag import thomas_factor, thomas_solve_factored
from .heston_adi import (
    HestonPDEResult,
    _a1_diags,
    _a2_diags,
    _apply_a0,
    _apply_a1,
    _apply_a2,
    _assemble_a1,
)
from .pide import KouJumps, MertonJumps, _jump_matrix

__all__ = ["BatesPIDEParams", "solve_bates_pide"]


class BatesPIDEParams(NamedTuple):
    """Heston grid/contract inputs plus the jump leg.

    Field semantics match :class:`pde_tpu.solvers.heston_adi.HestonPDEParams`
    (grid defaults from the reference, heston_pde.hpp:56-61); ``jumps`` is a
    :class:`~pde_tpu.solvers.pide.MertonJumps` (= Bates 1996) or
    :class:`~pde_tpu.solvers.pide.KouJumps` instance.
    """

    kappa: float = 2.0
    theta: float = 0.04
    sigma: float = 0.3
    rho: float = -0.7
    v0: float = 0.04
    r: float = 0.05
    q: float = 0.0
    T: float = 1.0
    K: float = 100.0
    is_call: bool = True
    american: bool = False
    jumps: object = MertonJumps(0.5, -0.1, 0.15)
    n_spot: int = 100
    n_vol: int = 50
    n_time: int = 100
    s_min_mult: float = 0.2
    s_max_mult: float = 5.0
    v_max: float = 1.0
    american_method: str = "projection"


def _solve_core(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, jumps,
    *,
    american: bool,
    american_method: str,
    n_spot: int,
    n_vol: int,
    n_time: int,
    s_min_mult: float,
    s_max_mult: float,
    v_max: float,
):
    nS, nv, nT = n_spot, n_vol, n_time
    is_call_q = jnp.asarray(is_call)
    x = jnp.linspace(jnp.log(K * s_min_mult), jnp.log(K * s_max_mult), nS)
    s_grid = jnp.exp(x)
    dx = (x[-1] - x[0]) / (nS - 1)
    v_grid = jnp.linspace(0.0, v_max, nv)
    dv = v_max / (nv - 1)
    dt = T / nT
    th = 0.5  # Douglas parameter

    lam, kbar = jumps.lam, jumps.kbar

    payoff_1d = jnp.where(
        is_call_q, jnp.maximum(s_grid - K, 0.0), jnp.maximum(K - s_grid, 0.0)
    )
    payoff = jnp.broadcast_to(payoff_1d[:, None], (nS, nv))

    # local operator = Heston operator with the compensator folded into the
    # x-drift (r - q - lam*kbar - v/2, entered as an effective dividend) and
    # the jump intensity added to the discount, split evenly across the two
    # sweeps like the reference splits -r (heston_adi._a1_diags/_a2_diags)
    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q + lam * kbar)
    di_v = di_v - 0.5 * lam
    a1_lower, a1_diag, a1_upper = _assemble_a1(nS, nv, lo_v, di_v, up_v)
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, kappa, theta, sigma, r)
    # -lam/2 on every PDE row of the v operator (the v_max row is Dirichlet
    # and stays an identity row)
    a2_diag = a2_diag.at[:-1].add(-0.5 * lam)

    i1_factors = thomas_factor(-th * dt * a1_lower, 1.0 - th * dt * a1_diag,
                               -th * dt * a1_upper)
    i2_factors = thomas_factor(-th * dt * a2_lower, 1.0 - th * dt * a2_diag,
                               -th * dt * a2_upper)

    # jump quadrature: Toeplitz (nS, nS) matrix + closed-form edge tails
    # (same construction as solvers/pide.py, applied across all nv columns)
    W = _jump_matrix(jumps, x, dx)
    bu, au = jumps.tail_up(x[-1] - x)    # (nS,)
    bd, ad = jumps.tail_down(x[0] - x)

    def jump_term(V, tau):
        conv = jnp.matmul(W, V, precision=jax.lax.Precision.HIGHEST)  # (nS, nv)
        if american:
            df_r = df_q = jnp.ones((), x.dtype)
        else:
            df_r, df_q = jnp.exp(-r * tau), jnp.exp(-q * tau)
        tail_call = jnp.maximum(df_q * s_grid * au - df_r * K * bu, 0.0)
        tail_put = jnp.maximum(df_r * K * bd - df_q * s_grid * ad, 0.0)
        tail = jnp.where(is_call_q, tail_call, tail_put)
        out = lam * (conv + tail[:, None])
        # x-boundary rows and the Dirichlet v_max column are reimposed each
        # step; keep the explicit source off them so the first interior
        # implicit rows do not read a corrupted boundary value
        out = out.at[0, :].set(0.0).at[-1, :].set(0.0).at[:, -1].set(0.0)
        return out

    def apply_bc(V, tau):
        df_r = jnp.exp(-r * tau)
        df_q = jnp.exp(-q * tau)
        V = V.at[0, :].set(jnp.where(is_call_q, 0.0, K * df_r - s_grid[0] * df_q))
        V = V.at[-1, :].set(jnp.where(is_call_q, s_grid[-1] * df_q - K * df_r, 0.0))
        V = V.at[:, -1].set(jnp.where(is_call_q, s_grid * df_q, K * df_r))
        return V

    use_it = american and american_method == "it_lcp"

    def step(carry, tau):
        V, lam_it, J_prev = carry
        J_now = jump_term(V, tau)
        # CNAB: second-order Adams-Bashforth extrapolation of the explicit
        # non-local term (Salmi-Toivanen-von Sydow 2014, scheme (14))
        J_ab = 1.5 * J_now - 0.5 * J_prev
        a0V = _apply_a0(V, v_grid, dx, dv, rho, sigma)
        a1V = _apply_a1(V, a1_lower, a1_diag, a1_upper)
        a2V = _apply_a2(V, a2_lower, a2_diag, a2_upper)
        Y0 = V + dt * (a0V + a1V + a2V + J_ab + lam_it)
        rhs1 = Y0 - th * dt * a1V
        Y1 = thomas_solve_factored(i1_factors, rhs1.T).T
        rhs2 = Y1 - th * dt * a2V
        Vt = thomas_solve_factored(i2_factors, rhs2)
        if use_it:
            Wv = Vt - dt * lam_it
            V_new = jnp.maximum(payoff, Wv)
            lam_it = (V_new - Wv) / dt
            Vt = V_new
        Vt = apply_bc(Vt, tau)
        if american:
            Vt = jnp.maximum(Vt, payoff)
        return (Vt, lam_it, J_now), None

    taus = dt * jnp.arange(1, nT + 1, dtype=s_grid.dtype)
    init = (payoff, jnp.zeros_like(payoff), jump_term(payoff, taus[0] * 0.0))
    (V, _, _), _ = jax.lax.scan(step, init, taus)

    price = grids.interp_bilinear(s_grid, v_grid, V, S0, v0)
    i = jnp.clip(grids.find_index(s_grid, S0), 1, nS - 2)
    j = jnp.clip(grids.find_index(v_grid, v0), 1, nv - 2)
    # Uniform-in-log-S grid: difference in x = log S and convert (the naive
    # /davg^2 stencil on S values has an O(1) ~ delta/S bias), then
    # Taylor-shift the nodal derivatives to x = 0 — with even nS the spot
    # sits BETWEEN nodes, a dx/2 offset the shift removes (see pide.py).
    V_x_i = (V[i + 1, j] - V[i - 1, j]) / (2.0 * dx)
    V_xx_i = (V[i + 1, j] - 2.0 * V[i, j] + V[i - 1, j]) / (dx * dx)
    V_x0 = V_x_i + V_xx_i * (jnp.log(S0) - x[i])   # x is absolute log S here
    delta = V_x0 / S0
    gamma = (V_xx_i - V_x0) / (S0 * S0)
    dV_dv = (V[i, j + 1] - V[i, j - 1]) / (2.0 * dv)
    vega = 2.0 * jnp.sqrt(v0) * T * dV_dv
    theta_g = -(
        _apply_a0(V, v_grid, dx, dv, rho, sigma)
        + _apply_a1(V, a1_lower, a1_diag, a1_upper)
        + _apply_a2(V, a2_lower, a2_diag, a2_upper)
        + jump_term(V, jnp.zeros((), x.dtype))
    )[i, j]
    return HestonPDEResult(price, delta, gamma, vega, theta_g, V, s_grid, v_grid)


@functools.partial(
    jax.jit,
    static_argnames=(
        "american", "american_method", "n_spot", "n_vol", "n_time",
        "s_min_mult", "s_max_mult", "v_max", "jump_type",
    ),
)
def _solve_impl(kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
                jump_arr, *, american, american_method, n_spot, n_vol,
                n_time, s_min_mult, s_max_mult, v_max, jump_type):
    jumps = (MertonJumps if jump_type == "merton" else KouJumps)(*jump_arr)
    return _solve_core(
        kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, jumps,
        american=american, american_method=american_method,
        n_spot=n_spot, n_vol=n_vol, n_time=n_time,
        s_min_mult=s_min_mult, s_max_mult=s_max_mult, v_max=v_max,
    )


def solve_bates_pide(params: BatesPIDEParams, S0) -> HestonPDEResult:
    """Solve the Bates PIDE and return price/Greeks at ``(S0, v0)``.

    All model/contract inputs are traced — ``vmap`` over strikes, spots,
    maturities, or whole parameter pytrees reuses one compiled march, as in
    :func:`pde_tpu.solvers.heston_adi.solve_batch`.
    """
    p = params
    if isinstance(p.jumps, MertonJumps):
        jtype = "merton"
    elif isinstance(p.jumps, KouJumps):
        jtype = "kou"
    else:
        raise TypeError(f"unsupported jump family {type(p.jumps).__name__}")
    if p.american_method not in ("projection", "it_lcp"):
        raise ValueError(f"unknown american_method {p.american_method!r}")
    if p.n_spot < 16 or p.n_vol < 8 or p.n_time < 10:
        raise ValueError("grid too small: need n_spot>=16, n_vol>=8, n_time>=10")
    return _solve_impl(
        p.kappa, p.theta, p.sigma, p.rho, p.v0, p.r, p.q, p.T, p.K,
        bool(p.is_call), S0,
        tuple(jnp.asarray(v, float) for v in p.jumps),
        american=bool(p.american), american_method=p.american_method,
        n_spot=p.n_spot, n_vol=p.n_vol, n_time=p.n_time,
        s_min_mult=p.s_min_mult, s_max_mult=p.s_max_mult, v_max=p.v_max,
        jump_type=jtype,
    )
