"""Grid-sharded IMPLICIT PDE marches — CN Black-Scholes and Heston Douglas ADI.

This is the round-2 answer to the round-1 gap: the production implicit
sweeps (the whole point of the reference's ADI solver,
src/cpp/solvers/heston_pde.hpp:217-242 / pde_core.hpp:408-436) running with
the SPOT GRID AXIS SHARDED across the device mesh.  Per time step, inside
one ``shard_map``-compiled ``lax.scan``:

* the explicit stencils (A0 mixed derivative, A1 spot operator) exchange
  one-row halos with the neighbor devices (two ``ppermute``s between neighbouring devices);
* the implicit S-sweep — tridiagonal along the SHARDED axis, batched over
  the v levels — runs as Wang's partitioned Thomas
  (:func:`pde_tpu.parallel.dist_tridiag.partitioned_thomas_spmd`): local
  elimination, one tiny ``all_gather``-reduced interface system, local back
  substitution;
* the implicit v-sweep is tridiagonal along the LOCAL axis — plain batched
  Thomas, zero communication (the ADI splitting's axes alternate between
  sharded and local, so only one sweep family per step pays for comms).

Numerical equivalence with the single-device solvers
(``solvers/bs_pde.solve``, ``solvers/heston_adi.solve``) is exact up to
partitioned-elimination roundoff and is asserted at f64 tolerance on the
8-device virtual mesh in tests/test_parallel.py; ``dryrun_multichip``
exercises the same march.

Why shard the grid at all: one device's memory bounds the grid; the
reference caps grids at 100x50 (heston_pde.hpp:60) partly because its
per-slice Thomas loops are serial.  Sharding the S axis scales the grid
linearly in devices for dense-surface marches (SURVEY.md §5 "long-axis"
scaling) while keeping every sweep batched on-chip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core import grids
from ..ops.tridiag import thomas
from ..solvers.bs_pde import BSPDEParams, BSPDEResult, _operator_coeffs, _readout_1d
from ..solvers.heston_adi import (
    HestonPDEParams,
    HestonPDEResult,
    _a1_diags,
    _a2_diags,
    _assemble_a1,
    _apply_a0,
    _apply_a1,
    _apply_a2,
)
from .dist_tridiag import partitioned_thomas_spmd

__all__ = ["sharded_bs_solve", "sharded_heston_solve"]


def _row_aligned(lower, diag, upper):
    """thomas-convention bands (n-1), (n), (n-1) -> row-aligned a, b, c (n,)."""
    zero = jnp.zeros(lower.shape[:-1] + (1,), diag.dtype)
    a = jnp.concatenate([zero, lower], axis=-1)
    c = jnp.concatenate([upper, zero], axis=-1)
    return a, diag, c


def _halo_perms(ndev):
    right = [(i, (i + 1) % ndev) for i in range(ndev)]
    left = [(i, (i - 1) % ndev) for i in range(ndev)]
    return right, left


# --------------------------------------------------------------------------
# 1D Black-Scholes, Crank-Nicolson/implicit, S axis sharded
# --------------------------------------------------------------------------


def sharded_bs_solve(mesh: Mesh, params: BSPDEParams, S0) -> BSPDEResult:
    """CN/implicit BS march with the spot axis sharded over the mesh.

    Same discretization and boundary treatment as ``solvers/bs_pde.solve``
    (whose docstring records the reference deviations); per step the
    implicit system — tridiagonal along the sharded axis — is solved with
    partitioned Thomas.  ``american_method`` "projection" only (PSOR's
    red-black sweeps across shard boundaries are not distributed here).
    """
    if params.scheme not in ("crank_nicolson", "implicit"):
        raise ValueError("sharded_bs_solve is the implicit-path demo: use "
                         "scheme 'crank_nicolson' or 'implicit'")
    if params.american and params.american_method != "projection":
        raise ValueError("sharded_bs_solve supports american_method='projection'")
    axis = mesh.axis_names[0]
    ndev = mesh.shape[axis]
    n = params.n_space
    if n % ndev != 0:
        raise ValueError(f"n_space={n} not divisible by mesh size {ndev}")

    K, r, q, T = params.K, params.r, params.q, params.T
    is_call = bool(params.is_call)
    s_grid = jnp.exp(
        jnp.linspace(jnp.log(K * params.s_min_mult), jnp.log(K * params.s_max_mult), n)
    )
    dx = jnp.log(s_grid[-1] / s_grid[0]) / (n - 1)
    dt = T / params.n_time
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[params.scheme]

    payoff = jnp.where(is_call, jnp.maximum(s_grid - K, 0.0), jnp.maximum(K - s_grid, 0.0))
    L_m, L_c, L_p = _operator_coeffs(params, dx)
    gi = jnp.arange(n)
    interior = ((gi > 0) & (gi < n - 1)).astype(s_grid.dtype)
    # row-aligned explicit operator and implicit (I - w dt L) bands
    La = L_m * interior
    Lb = L_c * interior
    Lc_ = L_p * interior
    ia = -w * dt * La
    ib = jnp.where(interior > 0, 1.0 - w * dt * L_c, 1.0)
    ic = -w * dt * Lc_

    taus = dt * jnp.arange(1, params.n_time + 1, dtype=s_grid.dtype)
    right_perm, left_perm = _halo_perms(ndev)

    def shard_fn(payoff_l, La_l, Lb_l, Lc_l, ia_l, ib_l, ic_l, sg_l, taus_r):
        idx = jax.lax.axis_index(axis)
        is_first = idx == 0
        is_last = idx == ndev - 1
        m = payoff_l.shape[0]

        def step(V, tau):
            lg = jax.lax.ppermute(V[-1], axis, right_perm)
            rg = jax.lax.ppermute(V[0], axis, left_perm)
            left = jnp.concatenate([lg[None], V[:-1]])
            right = jnp.concatenate([V[1:], rg[None]])
            rhs = V + (1.0 - w) * dt * (La_l * left + Lb_l * V + Lc_l * right)
            V = partitioned_thomas_spmd(ia_l, ib_l, ic_l, rhs, axis)
            # Dirichlet boundaries (discounted over time-to-expiry)
            df_r = jnp.exp(-r * tau)
            df_q = jnp.exp(-q * tau)
            lo = jnp.where(is_call, 0.0, K * df_r - sg_l[0] * df_q)
            hi = jnp.where(is_call, sg_l[-1] * df_q - K * df_r, 0.0)
            V = jnp.where(is_first, V.at[0].set(lo), V)
            V = jnp.where(is_last, V.at[m - 1].set(hi), V)
            if params.american:
                V = jnp.maximum(V, payoff_l)
            return V, None

        V, _ = jax.lax.scan(step, payoff_l, taus_r)
        return V

    fn = jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis),) * 8 + (P(),),
            out_specs=P(axis),
        )
    )
    V = fn(payoff, La, Lb, Lc_, ia, ib, ic, s_grid, taus)

    price, delta, gamma, theta, early_ex = _readout_1d(
        V, s_grid, S0, K, params.sigma, r, q, T, is_call, params.american
    )
    return BSPDEResult(price, delta, gamma, theta, V, s_grid, early_ex)


# --------------------------------------------------------------------------
# 2D Heston Douglas ADI, S axis sharded
# --------------------------------------------------------------------------


def sharded_heston_solve(mesh: Mesh, params: HestonPDEParams, S0) -> HestonPDEResult:
    """Heston Douglas ADI march with the spot axis sharded over the mesh.

    Identical scheme/boundaries to ``solvers/heston_adi.solve`` (Douglas
    splitting, In 't Hout-Foulon BCs, projection or Ikonen-Toivanen
    American); the S-implicit sweep family — (nv) tridiagonal systems along
    the sharded axis — runs as partitioned Thomas, the v-sweep family stays
    a local batched Thomas, and the explicit A0/A1 stencils exchange
    one-row halos.
    """
    axis = mesh.axis_names[0]
    ndev = mesh.shape[axis]
    nS, nv, nT = params.n_spot, params.n_vol, params.n_time
    if nS % ndev != 0:
        raise ValueError(f"n_spot={nS} not divisible by mesh size {ndev}")
    if params.american and params.american_method not in ("projection", "it_lcp"):
        raise ValueError("american_method must be 'projection' or 'it_lcp'")
    if params.scheme != "douglas":
        raise ValueError("sharded march implements the Douglas scheme")

    kappa, theta_p, sigma, rho = params.kappa, params.theta, params.sigma, params.rho
    v0, r, q, T, K = params.v0, params.r, params.q, params.T, params.K
    is_call = bool(params.is_call)
    use_it = params.american and params.american_method == "it_lcp"

    x = jnp.linspace(jnp.log(K * params.s_min_mult), jnp.log(K * params.s_max_mult), nS)
    s_grid = jnp.exp(x)
    dx = (x[-1] - x[0]) / (nS - 1)
    v_grid = jnp.linspace(0.0, params.v_max, nv)
    dv = params.v_max / (nv - 1)
    dt = T / nT
    th = 0.5  # Douglas parameter

    payoff_1d = jnp.where(is_call, jnp.maximum(s_grid - K, 0.0), jnp.maximum(K - s_grid, 0.0))
    payoff = jnp.broadcast_to(payoff_1d[:, None], (nS, nv))

    # A1 (spot operator): per-v interior constants -> row-aligned (nS, nv)
    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q)          # (nv, 1) each
    gi = jnp.arange(nS)
    interior = ((gi > 0) & (gi < nS - 1)).astype(s_grid.dtype)[:, None]  # (nS, 1)
    a1a = (lo_v.T * interior)                                # coeff on V[i-1, j]
    a1b = (di_v.T * interior)
    a1c = (up_v.T * interior)                                # coeff on V[i+1, j]
    i1a = -th * dt * a1a
    i1b = jnp.where(interior > 0, 1.0 - th * dt * di_v.T, 1.0) * jnp.ones((nS, nv), s_grid.dtype)
    i1c = -th * dt * a1c

    # A2 (vol operator): thomas-convention bands shared by every S row
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, kappa, theta_p, sigma, r)
    a2a, a2b, a2c = _row_aligned(a2_lower, a2_diag, a2_upper)
    i2_lower = -th * dt * a2_lower
    i2_diag = 1.0 - th * dt * a2_diag
    i2_upper = -th * dt * a2_upper

    mixed_coef = rho * sigma * v_grid  # (nv,)
    taus = dt * jnp.arange(1, nT + 1, dtype=s_grid.dtype)
    right_perm, left_perm = _halo_perms(ndev)

    def shard_fn(payoff_l, a1a_l, a1b_l, a1c_l, i1a_l, i1b_l, i1c_l, sg_l,
                 a2a_r, a2b_r, a2c_r, i2lo_r, i2di_r, i2up_r, mixed_r, taus_r):
        idx = jax.lax.axis_index(axis)
        is_first = idx == 0
        is_last = idx == ndev - 1
        m = payoff_l.shape[0]
        gidx = idx * m + jnp.arange(m)  # global S-row indices of this shard
        smask = ((gidx > 0) & (gidx < nS - 1)).astype(payoff_l.dtype)[:, None]

        def exchange(V):
            lg = jax.lax.ppermute(V[-1], axis, right_perm)  # left neighbor's last row
            rg = jax.lax.ppermute(V[0], axis, left_perm)    # right neighbor's first row
            return lg, rg

        def apply_a1_local(V, lg, rg):
            left = jnp.concatenate([lg[None], V[:-1]])
            right = jnp.concatenate([V[1:], rg[None]])
            return a1a_l * left + a1b_l * V + a1c_l * right

        def apply_a2_local(V):
            out = V * a2b_r[None, :]
            out = out.at[:, 1:].add(V[:, :-1] * a2a_r[None, 1:])
            out = out.at[:, :-1].add(V[:, 1:] * a2c_r[None, :-1])
            return out

        def apply_a0_local(V, lg, rg):
            V_ext = jnp.concatenate([lg[None], V, rg[None]])  # (m+2, nv)
            V_xv = (
                V_ext[2:, 2:] - V_ext[2:, :-2] - V_ext[:-2, 2:] + V_ext[:-2, :-2]
            ) / (4.0 * dx * dv)
            out = mixed_r[None, 1:-1] * V_xv                  # (m, nv-2)
            out = jnp.pad(out, ((0, 0), (1, 1)))
            return out * smask                                 # zero global-edge rows

        def apply_bc(V, tau):
            df_r = jnp.exp(-r * tau)
            df_q = jnp.exp(-q * tau)
            lo = jnp.where(is_call, 0.0, K * df_r - sg_l[0] * df_q)
            hi = jnp.where(is_call, sg_l[-1] * df_q - K * df_r, 0.0)
            V = jnp.where(is_first, V.at[0, :].set(lo), V)
            V = jnp.where(is_last, V.at[m - 1, :].set(hi), V)
            V = V.at[:, -1].set(jnp.where(is_call, sg_l * df_q, K * df_r))
            return V

        def adi_step(V, source):
            lg, rg = exchange(V)
            a1V = apply_a1_local(V, lg, rg)
            a2V = apply_a2_local(V)
            F = apply_a0_local(V, lg, rg) + a1V + a2V
            Y0 = V + dt * (F + source)

            rhs1 = Y0 - th * dt * a1V
            Y1 = partitioned_thomas_spmd(
                i1a_l.T, i1b_l.T, i1c_l.T, rhs1.T, axis
            ).T

            rhs2 = Y1 - th * dt * a2V
            Y2 = thomas(i2lo_r, i2di_r, i2up_r, rhs2)
            return Y2

        def step(carry, tau):
            V, lam = carry
            Vt = adi_step(V, lam)
            if use_it:
                W = Vt - dt * lam
                V_new = jnp.maximum(payoff_l, W)
                lam = (V_new - W) / dt
                Vt = V_new
            Vt = apply_bc(Vt, tau)
            if params.american and not use_it:
                Vt = jnp.maximum(Vt, payoff_l)
            if use_it:
                Vt = jnp.where(is_first, Vt.at[0, :].set(jnp.maximum(Vt[0, :], payoff_l[0, :])), Vt)
                Vt = jnp.where(is_last, Vt.at[m - 1, :].set(jnp.maximum(Vt[m - 1, :], payoff_l[m - 1, :])), Vt)
                Vt = Vt.at[:, 0].set(jnp.maximum(Vt[:, 0], payoff_l[:, 0]))
                Vt = Vt.at[:, -1].set(jnp.maximum(Vt[:, -1], payoff_l[:, -1]))
            return (Vt, lam), None

        (V, _), _ = jax.lax.scan(step, (payoff_l, jnp.zeros_like(payoff_l)), taus_r)
        return V

    grid_spec = P(axis, None)
    rep = P()
    rep1 = P(None)
    fn = jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(grid_spec,) * 7 + (P(axis),) + (rep1,) * 8,
            out_specs=grid_spec,
        )
    )
    V = fn(payoff, a1a, a1b, a1c, i1a, i1b, i1c, s_grid,
           a2a, a2b, a2c, i2_lower, i2_diag, i2_upper, mixed_coef, taus)

    # price/Greeks from the (globally-viewed) grid — same formulas as
    # heston_adi._solve_core; XLA inserts the gathers these indexings need
    price = grids.interp_bilinear(s_grid, v_grid, V, S0, v0)
    i = jnp.clip(grids.find_index(s_grid, S0), 1, nS - 2)
    j = jnp.clip(grids.find_index(v_grid, v0), 1, nv - 2)
    delta = (V[i + 1, j] - V[i - 1, j]) / (s_grid[i + 1] - s_grid[i - 1])
    davg = 0.5 * (s_grid[i + 1] - s_grid[i - 1])
    gamma = (V[i + 1, j] - 2.0 * V[i, j] + V[i - 1, j]) / (davg * davg)
    dV_dv = (V[i, j + 1] - V[i, j - 1]) / (2.0 * dv)
    vega = 2.0 * jnp.sqrt(v0) * T * dV_dv
    a1l, a1d, a1u = _assemble_a1(nS, nv, lo_v, di_v, up_v)
    theta_g = -(
        _apply_a0(V, v_grid, dx, dv, rho, sigma)
        + _apply_a1(V, a1l, a1d, a1u)
        + _apply_a2(V, a2_lower, a2_diag, a2_upper)
    )[i, j]
    return HestonPDEResult(price, delta, gamma, vega, theta_g, V, s_grid, v_grid)
