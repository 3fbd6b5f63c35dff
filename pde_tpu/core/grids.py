"""Functional spatial grids for PDE solvers.

Functional redesign of the reference's ``Grid1D``/``Grid2D`` classes
(reference: src/cpp/solvers/pde_core.hpp:31-180).  Instead of stateful grid
objects, grids here are plain jnp arrays produced by pure constructors, and
lookup/interpolation are pure functions that are jit/vmap-compatible
(``searchsorted`` instead of a scalar binary-search loop).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = [
    "uniform_grid",
    "log_grid",
    "uniform_step",
    "find_index",
    "interp_linear",
    "interp_bilinear",
]


def uniform_grid(x_min: float, x_max: float, n_points: int, dtype=None) -> jnp.ndarray:
    """Uniformly spaced grid of ``n_points`` points on [x_min, x_max]."""
    if n_points < 3:
        raise ValueError("grid requires at least 3 points")
    if not (x_min < x_max):
        raise ValueError("x_min must be less than x_max")
    return jnp.linspace(x_min, x_max, n_points, dtype=dtype)


def log_grid(x_min: float, x_max: float, n_points: int, dtype=None) -> jnp.ndarray:
    """Grid uniform in log(x); more resolution near small x (e.g. the strike).

    Matches the reference's log-space grid construction
    (src/cpp/solvers/pde_core.hpp:57-64).
    """
    if n_points < 3:
        raise ValueError("grid requires at least 3 points")
    if x_min <= 0:
        raise ValueError("log grid requires x_min > 0")
    if not (x_min < x_max):
        raise ValueError("x_min must be less than x_max")
    lx = jnp.linspace(jnp.log(x_min), jnp.log(x_max), n_points, dtype=dtype)
    return jnp.exp(lx)


def uniform_step(grid: jnp.ndarray, log_space: bool = False) -> jnp.ndarray:
    """Uniform step in the grid's natural coordinate.

    For log-space grids this is the step in log coordinates
    (reference semantics: src/cpp/solvers/pde_core.hpp:89-94).
    """
    n = grid.shape[-1]
    if log_space:
        return jnp.log(grid[..., -1] / grid[..., 0]) / (n - 1)
    return (grid[..., -1] - grid[..., 0]) / (n - 1)


def find_index(grid: jnp.ndarray, x) -> jnp.ndarray:
    """Index of the grid point closest to ``x`` (vectorized over x).

    Mirrors Grid1D::find_index (src/cpp/solvers/pde_core.hpp:102-118): clamps
    to the ends and returns the *closer* of the two bracketing points.
    """
    x = jnp.asarray(x)
    n = grid.shape[-1]
    hi = jnp.clip(jnp.searchsorted(grid, x, side="right"), 1, n - 1)
    lo = hi - 1
    closer_lo = (x - grid[lo]) < (grid[hi] - x)
    idx = jnp.where(closer_lo, lo, hi)
    idx = jnp.where(x <= grid[0], 0, idx)
    idx = jnp.where(x >= grid[n - 1], n - 1, idx)
    return idx


def interp_linear(grid: jnp.ndarray, values: jnp.ndarray, x) -> jnp.ndarray:
    """Linear interpolation of ``values`` defined on ``grid`` at points ``x``.

    Clamps outside the grid to the boundary values, matching
    Grid1D::interpolate (src/cpp/solvers/pde_core.hpp:123-133).
    """
    return jnp.interp(jnp.asarray(x), grid, values)


def interp_bilinear(
    x_grid: jnp.ndarray,
    y_grid: jnp.ndarray,
    values: jnp.ndarray,
    x,
    y,
) -> jnp.ndarray:
    """Bilinear interpolation on a 2D tensor-product grid.

    ``values`` has shape (nx, ny).  Serves the role of
    HestonPDESolver::interpolate_2d (src/cpp/solvers/heston_pde.hpp:481-504)
    but with proper bracketing: the reference snaps to the *closest* grid
    point before interpolating, which clamps the weight and loses up to half
    a cell of accuracy; here the true enclosing cell is used.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    nx = x_grid.shape[-1]
    ny = y_grid.shape[-1]

    i = jnp.clip(jnp.searchsorted(x_grid, x, side="right"), 1, nx - 1)
    j = jnp.clip(jnp.searchsorted(y_grid, y, side="right"), 1, ny - 1)

    tx = (x - x_grid[i - 1]) / (x_grid[i] - x_grid[i - 1])
    ty = (y - y_grid[j - 1]) / (y_grid[j] - y_grid[j - 1])
    tx = jnp.clip(tx, 0.0, 1.0)
    ty = jnp.clip(ty, 0.0, 1.0)

    return (
        (1 - tx) * (1 - ty) * values[i - 1, j - 1]
        + tx * (1 - ty) * values[i, j - 1]
        + (1 - tx) * ty * values[i - 1, j]
        + tx * ty * values[i, j]
    )
