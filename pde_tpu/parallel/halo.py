"""Grid-axis sharded PDE stepping with halo exchange.

SURVEY.md section 5 identifies the PDE grid axes as this framework's
"long-axis" scaling problem: grids beyond one core's memory shard across the
mesh, and stencil boundaries exchange one-cell halos — the
context/ring-attention analog for finite differences.  This module
implements it with ``shard_map`` + ``lax.ppermute``:

* the spatial axis is split across the ``grid`` mesh axis;
* each explicit stencil step exchanges left/right edge cells with the
  neighboring devices (two ppermutes between neighbours);
* the time march stays a local ``lax.scan`` — communication happens inside
  the compiled program, not per step from the host.

Demonstrated on the log-space Black-Scholes operator (explicit scheme; the
implicit sweeps pair this with the batched Thomas kernels per shard).
Numerical equivalence with the single-device solver is tested on the virtual
8-device CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["sharded_bs_explicit", "make_grid_mesh"]


def make_grid_mesh(n_devices: int, axis: str = "grid") -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n_devices]), (axis,))


def _exchange_halos(V, axis_name: str):
    """Fetch the neighbor edge cells: returns (left_ghost, right_ghost).

    Edge devices receive a ghost from the wrap-around neighbor but mask it
    out in the stencil (Dirichlet boundaries live on the global edges).
    """
    n_dev = jax.lax.psum(1, axis_name)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    # my last cell -> right neighbor's left ghost
    left_ghost = jax.lax.ppermute(V[-1], axis_name, right_perm)
    # my first cell -> left neighbor's right ghost
    right_ghost = jax.lax.ppermute(V[0], axis_name, left_perm)
    return left_ghost, right_ghost


def sharded_bs_explicit(
    mesh: Mesh,
    sigma: float,
    r: float,
    q: float,
    T: float,
    K: float,
    n_space: int,
    n_time: int,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    is_call: bool = True,
):
    """Explicit log-space BS march with the S-axis sharded over the mesh.

    Returns (s_grid, V) as global (replicated-layout) arrays.  n_space must
    be divisible by the mesh size.  Explicit stepping needs dt below the CFL
    bound — callers pick n_time accordingly (compute_stable_dt semantics,
    reference pde_core.hpp:307).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    if n_space % n_dev != 0:
        raise ValueError(f"n_space={n_space} not divisible by mesh size {n_dev}")

    x = np.linspace(np.log(K * s_min_mult), np.log(K * s_max_mult), n_space)
    s_grid = jnp.asarray(np.exp(x))
    dx = float(x[1] - x[0])
    dt = T / n_time

    sigma2 = sigma * sigma
    a = 0.5 * sigma2 / (dx * dx)
    b = (r - q - 0.5 * sigma2) / (2.0 * dx)
    L_m, L_c, L_p = a - b, -2.0 * a - r, a + b

    payoff_global = jnp.where(
        is_call, jnp.maximum(s_grid - K, 0.0), jnp.maximum(K - s_grid, 0.0)
    )

    def shard_fn(V_local, s_local):
        idx = jax.lax.axis_index(axis)
        is_first = idx == 0
        is_last = idx == n_dev - 1
        m = V_local.shape[0]

        def step(V, tau):
            lg, rg = _exchange_halos(V, axis)
            left = jnp.concatenate([lg[None], V[:-1]])
            right = jnp.concatenate([V[1:], rg[None]])
            LV = L_m * left + L_c * V + L_p * right
            V_new = V + dt * LV

            # global Dirichlet boundaries, discounted over time-to-expiry
            # with the dividend leg on S (the corrected convention of
            # solvers/bs_pde.py apply_bc; the reference's calendar-time
            # discount is a non-converging wing error)
            df_r = jnp.exp(-r * tau)
            df_q = jnp.exp(-q * tau)
            lo = jnp.where(is_call, 0.0, K * df_r - s_local[0] * df_q)
            hi = jnp.where(is_call, s_local[-1] * df_q - K * df_r, 0.0)
            V_new = jnp.where(
                is_first, V_new.at[0].set(lo), V_new
            )
            V_new = jnp.where(
                is_last, V_new.at[m - 1].set(hi), V_new
            )
            return V_new, None

        taus = dt * jnp.arange(1, n_time + 1, dtype=V_local.dtype)
        V_final, _ = jax.lax.scan(step, V_local, taus)
        return V_final

    from jax import shard_map

    fn = jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
        )
    )
    V = fn(payoff_global, s_grid)
    return s_grid, V
