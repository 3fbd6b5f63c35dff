"""Linear-complementarity (obstacle) solvers: projected SOR and Brennan-Schwartz.

BASELINE.json names the free-boundary PSOR formulation (Leung & Li 2015) as a
benchmark config; the reference itself only ships the simpler
implicit-then-project splitting (hjb_solver.hpp:163-178, also used for
American exercise in its PDE solvers).  This module provides the rigorous
LCP solve:

    A x >= b,   x >= g,   (x - g)^T (A x - b) = 0

for tridiagonal A, via **red-black projected SOR**: classic PSOR sweeps are
sequential in i, but for a tridiagonal operator the even rows depend only on
odd neighbours and vice versa, so each half-sweep is one fully vectorized
update.  Fixed iteration counts keep it
jittable; the residual is returned for monitoring.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["brennan_schwartz", "brennan_schwartz_factor",
           "brennan_schwartz_apply", "BrennanSchwartzFactors",
           "projected_sor", "psor_step"]


def _apply_tridiag(lower, diag, upper, x):
    """A x for tridiagonal A (lower/upper length n-1)."""
    out = diag * x
    out = out.at[..., 1:].add(lower * x[..., :-1])
    out = out.at[..., :-1].add(upper * x[..., 1:])
    return out


def psor_step(lower, diag, upper, b, g, x, omega, red_mask, black_mask):
    """One red-black projected SOR sweep (two vectorized half-updates)."""

    def half(x, mask):
        # Gauss-Seidel update for every row simultaneously; 'mask' selects
        # which color actually commits.  Rows of one color only read the
        # other color's entries, so the parallel update is exact GS.
        neighbor = jnp.zeros_like(x)
        neighbor = neighbor.at[..., 1:].add(lower * x[..., :-1])
        neighbor = neighbor.at[..., :-1].add(upper * x[..., 1:])
        gs = (b - neighbor) / diag
        x_new = x + omega * (gs - x)
        x_new = jnp.maximum(x_new, g)  # projection onto the obstacle
        return jnp.where(mask, x_new, x)

    x = half(x, red_mask)
    x = half(x, black_mask)
    return x


@partial(jax.jit, static_argnames=("n_iter",))
def projected_sor(
    lower,
    diag,
    upper,
    b,
    g,
    x0=None,
    omega: float = 1.5,
    n_iter: int = 60,
):
    """Solve the tridiagonal LCP with n_iter red-black PSOR sweeps.

    Shapes: lower/upper (..., n-1), diag/b/g/x0 (..., n); broadcasts over
    leading batch dims (vmap over options/spreads for books of American
    options / stopping problems).

    Returns (x, residual) where residual = max |min(A x - b, x - g)| — the
    LCP complementarity residual (0 at the exact solution).
    """
    lower = jnp.asarray(lower)
    diag = jnp.asarray(diag)
    upper = jnp.asarray(upper)
    b = jnp.asarray(b)
    g = jnp.asarray(g)
    n = diag.shape[-1]

    x = jnp.maximum(b / diag, g) if x0 is None else jnp.maximum(jnp.asarray(x0), g)

    idx = jnp.arange(n)
    red = (idx % 2 == 0)
    black = ~red

    def body(x, _):
        return psor_step(lower, diag, upper, b, g, x, omega, red, black), None

    x, _ = jax.lax.scan(body, x, None, length=n_iter)

    resid = jnp.max(jnp.abs(jnp.minimum(_apply_tridiag(lower, diag, upper, x) - b, x - g)))
    return x, resid


class BrennanSchwartzFactors(NamedTuple):
    """Elimination state for a time-INDEPENDENT operator (see
    :func:`brennan_schwartz_factor`)."""

    m: jnp.ndarray      # (..., n) elimination multipliers; m[..., n-1] = 0
    inv_d: jnp.ndarray  # (..., n) reciprocal eliminated pivots
    lo: jnp.ndarray     # (..., n) oriented row-aligned sub-diag; lo[..., 0] = 0
    rev: jnp.ndarray    # (..., 1) sweep-direction flags


def brennan_schwartz_factor(lower, diag, upper, reverse=False):
    """Eliminate the matrix once for repeated :func:`brennan_schwartz_apply`.

    Implicit obstacle marches solve the same operator every time step; the
    matrix elimination (the division-heavy half of the pass) depends only on
    the operator, so hoisting it leaves a multiply/fma-only serial chain per
    step.
    """
    lower = jnp.asarray(lower)
    diag = jnp.asarray(diag)
    upper = jnp.asarray(upper)
    n = diag.shape[-1]
    batch = jnp.broadcast_shapes(lower.shape[:-1], diag.shape[:-1],
                                 upper.shape[:-1], jnp.shape(reverse))
    rev = jnp.broadcast_to(jnp.asarray(reverse), batch)[..., None]

    # orient so the contact end is index 0; reversing index order swaps the
    # roles of the two off-diagonal bands
    lo = jnp.where(rev, jnp.flip(jnp.broadcast_to(upper, batch + (n - 1,)), -1),
                   jnp.broadcast_to(lower, batch + (n - 1,)))
    up = jnp.where(rev, jnp.flip(jnp.broadcast_to(lower, batch + (n - 1,)), -1),
                   jnp.broadcast_to(upper, batch + (n - 1,)))
    di = jnp.where(rev, jnp.flip(jnp.broadcast_to(diag, batch + (n,)), -1),
                   jnp.broadcast_to(diag, batch + (n,)))

    def front(a):
        return jnp.moveaxis(a, -1, 0)

    # eliminate the super-diagonal from the far end (i = n-1 down to 0);
    # row i couples to row i+1 through up[i]
    def elim(d_next, inp):
        d_i, u_i, l_i = inp
        m_i = u_i / d_next
        d_new = d_i - m_i * l_i
        return d_new, (m_i, d_new)

    inputs = (front(di[..., :-1])[::-1], front(up)[::-1], front(lo)[::-1])
    _, (m_rev, d_rev) = jax.lax.scan(elim, di[..., -1], inputs)
    m = jnp.concatenate([jnp.moveaxis(m_rev[::-1], 0, -1),
                         jnp.zeros(batch + (1,), diag.dtype)], axis=-1)
    d_tilde = jnp.concatenate(
        [jnp.moveaxis(d_rev[::-1], 0, -1), di[..., -1:]], axis=-1)
    lo_full = jnp.concatenate(
        [jnp.zeros(batch + (1,), diag.dtype), lo], axis=-1)
    return BrennanSchwartzFactors(m, 1.0 / d_tilde, lo_full, rev)


def brennan_schwartz_apply(factors: BrennanSchwartzFactors, b, g):
    """Projected solve with precomputed factors; returns x only."""
    m, inv_d, lo, rev = factors
    n = m.shape[-1]
    batch = jnp.broadcast_shapes(m.shape[:-1], jnp.asarray(b).shape[:-1],
                                 jnp.asarray(g).shape[:-1])
    bb = jnp.where(rev, jnp.flip(jnp.broadcast_to(b, batch + (n,)), -1),
                   jnp.broadcast_to(b, batch + (n,)))
    gg = jnp.where(rev, jnp.flip(jnp.broadcast_to(g, batch + (n,)), -1),
                   jnp.broadcast_to(g, batch + (n,)))
    m = jnp.broadcast_to(m, batch + (n,))
    inv_d = jnp.broadcast_to(inv_d, batch + (n,))
    lo = jnp.broadcast_to(lo, batch + (n,))

    def front(a):
        return jnp.moveaxis(a, -1, 0)

    # eliminate the rhs from the far end
    def elim(b_next, inp):
        b_i, m_i = inp
        b_new = b_i - m_i * b_next
        return b_new, b_new

    _, b_rev = jax.lax.scan(
        elim, bb[..., -1], (front(bb[..., :-1])[::-1], front(m[..., :-1])[::-1]))
    b_tilde = jnp.concatenate(
        [jnp.moveaxis(b_rev[::-1], 0, -1), bb[..., -1:]], axis=-1)

    # forward substitution INTO the contact end, projecting each row
    x0 = jnp.maximum(b_tilde[..., 0] * inv_d[..., 0], gg[..., 0])

    def sub(x_prev, inp):
        b_i, inv_i, l_i, g_i = inp
        x_i = jnp.maximum((b_i - l_i * x_prev) * inv_i, g_i)
        return x_i, x_i

    _, xs = jax.lax.scan(
        sub, x0,
        (front(b_tilde[..., 1:]), front(inv_d[..., 1:]), front(lo[..., 1:]),
         front(gg[..., 1:])))
    x = jnp.concatenate([x0[..., None], jnp.moveaxis(xs, 0, -1)], axis=-1)
    return jnp.where(rev, jnp.flip(x, axis=-1), x)


def brennan_schwartz(lower, diag, upper, b, g, reverse=False):
    """EXACT tridiagonal LCP solve in one projected pass (Brennan-Schwartz).

    When the contact region {x = g} is connected and anchored at ONE end of
    the grid — true for every one-sided optimal-stopping problem here
    (American exercise regions, the four OU entry/exit problems) — the LCP

        A x >= b,  x >= g,  (x - g)^T (A x - b) = 0

    is solved exactly by eliminating *away* from the contact end and back-
    substituting *into* it with a per-row projection (Brennan & Schwartz
    1977; Jaillet-Lamberton-Lapeyre 1990 prove correctness for M-matrices
    with one-sided contact).  Cost: two scans over the system axis — the
    same as an ordinary Thomas solve and ~``n_iter``x cheaper than PSOR,
    with zero iteration error.

    ``reverse=False`` assumes contact at the LEFT end (low index; e.g.
    entry-long, American put in S); ``reverse=True`` the right end.
    ``reverse`` may be a bool array over leading batch dims to mix
    directions in one batched call (solve_all_boundaries solves all four
    stopping problems, two of each direction, in one launch).

    Time marches with a constant operator should factor once with
    :func:`brennan_schwartz_factor` and call :func:`brennan_schwartz_apply`
    per step.

    Shapes as :func:`projected_sor`.  Returns (x, residual).
    """
    lower = jnp.asarray(lower)
    diag = jnp.asarray(diag)
    upper = jnp.asarray(upper)
    b = jnp.asarray(b)
    g = jnp.asarray(g)
    n = diag.shape[-1]
    batch = jnp.broadcast_shapes(lower.shape[:-1], diag.shape[:-1],
                                 b.shape[:-1], g.shape[:-1],
                                 jnp.shape(reverse))
    x = brennan_schwartz_apply(
        brennan_schwartz_factor(lower, diag, upper, reverse), b, g)
    resid = jnp.max(jnp.abs(jnp.minimum(
        _apply_tridiag(jnp.broadcast_to(lower, batch + (n - 1,)),
                       jnp.broadcast_to(diag, batch + (n,)),
                       jnp.broadcast_to(upper, batch + (n - 1,)), x) -
        jnp.broadcast_to(b, batch + (n,)),
        x - jnp.broadcast_to(g, batch + (n,)))))
    return x, resid
