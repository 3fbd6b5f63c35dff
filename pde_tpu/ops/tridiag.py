"""Batched tridiagonal solvers — the PDE inner kernel.

The reference solves one tridiagonal system at a time in C++
(solve_tridiagonal, src/cpp/solvers/pde_core.hpp:408-436), relying on the ADI
sweep loops for parallelism.  Here the recurrence stays sequential in the
system dimension while thousands of *independent* systems (v-slices x
options x strikes) advance together as one vector op.  Implementations:

* :func:`thomas` — ``lax.scan`` over the system axis with arbitrary leading
  batch dims.  Works on any backend/dtype (float64 parity mode) and is the
  autodiff-able reference.
* :func:`gtsv` — every system of the batch as one block-diagonal system
  through ``lax.linalg.tridiagonal_solve`` (one library call).
* :func:`pcr` — parallel cyclic reduction for the opposite regime: FEW but
  very LONG systems, where the sequential scan leaves the device idle.

:func:`tridiagonal_solve` dispatches between them by dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["thomas", "thomas_factor", "thomas_solve_factored", "ThomasFactors",
           "gtsv", "pcr", "tridiagonal_solve"]


class ThomasFactors(NamedTuple):
    """Precomputed forward-elimination state for a time-INDEPENDENT system.

    Implicit time marches (CN/implicit BS, ADI sweeps, HJB projection) solve
    the same tridiagonal operator every step with a new right-hand side;
    re-eliminating the matrix each step wastes the serial chain on divisions.
    :func:`thomas_factor` runs the elimination once; per-step
    :func:`thomas_solve_factored` is then multiply/fma-only in the sequential
    dimension.
    """

    cp: jnp.ndarray     # (..., n) super-diag multipliers; cp[..., n-1] = 0
    inv_m: jnp.ndarray  # (..., n) reciprocal pivots
    lo: jnp.ndarray     # (..., n) row-aligned sub-diagonal; lo[..., 0] = 0


def thomas_factor(lower, diag, upper) -> ThomasFactors:
    """Forward-eliminate the matrix only (shapes as :func:`thomas`)."""
    lower, diag, upper = map(jnp.asarray, (lower, diag, upper))
    n = diag.shape[-1]
    batch = jnp.broadcast_shapes(lower.shape[:-1], diag.shape[:-1],
                                 upper.shape[:-1])
    zeros = jnp.zeros(batch + (1,), diag.dtype)
    lo = jnp.concatenate([zeros, jnp.broadcast_to(lower, batch + (n - 1,))], -1)
    up = jnp.concatenate([jnp.broadcast_to(upper, batch + (n - 1,)), zeros], -1)
    d = jnp.broadcast_to(diag, batch + (n,))

    def front(a):
        return jnp.moveaxis(a, -1, 0)

    c0 = up[..., 0] / d[..., 0]
    inv0 = 1.0 / d[..., 0]

    def fwd(c_prev, x):
        lo_i, d_i, up_i = x
        inv_m = 1.0 / (d_i - lo_i * c_prev)
        c_i = up_i * inv_m
        return c_i, (c_i, inv_m)

    _, (cs, invs) = jax.lax.scan(
        fwd, c0, (front(lo)[1:], front(d)[1:], front(up)[1:]))
    cp = jnp.concatenate([c0[None], cs], axis=0)
    inv_m = jnp.concatenate([inv0[None], invs], axis=0)
    return ThomasFactors(jnp.moveaxis(cp, 0, -1), jnp.moveaxis(inv_m, 0, -1), lo)


def thomas_solve_factored(factors: ThomasFactors, rhs):
    """Solve with precomputed factors; only fma/multiply in the serial chain."""
    rhs = jnp.asarray(rhs)
    cp, inv_m, lo = factors
    n = cp.shape[-1]
    batch = jnp.broadcast_shapes(cp.shape[:-1], rhs.shape[:-1])
    b = jnp.broadcast_to(rhs, batch + (n,))
    cp = jnp.broadcast_to(cp, batch + (n,))
    inv_m = jnp.broadcast_to(inv_m, batch + (n,))
    lo = jnp.broadcast_to(lo, batch + (n,))

    def front(a):
        return jnp.moveaxis(a, -1, 0)

    dp0 = b[..., 0] * inv_m[..., 0]

    def fwd(dp_prev, x):
        lo_i, b_i, inv_i = x
        dp_i = (b_i - lo_i * dp_prev) * inv_i
        return dp_i, dp_i

    _, dps = jax.lax.scan(
        fwd, dp0, (front(lo)[1:], front(b)[1:], front(inv_m)[1:]))
    dps = jnp.concatenate([dp0[None], dps], axis=0)

    def bwd(x_next, x):
        c_i, dp_i = x
        x_i = dp_i - c_i * x_next
        return x_i, x_i

    _, xs = jax.lax.scan(bwd, dps[-1], (front(cp)[:-1], dps[:-1]), reverse=True)
    xs = jnp.concatenate([xs, dps[-1][None]], axis=0)
    return jnp.moveaxis(xs, 0, -1)


def thomas(lower: jnp.ndarray, diag: jnp.ndarray, upper: jnp.ndarray, rhs: jnp.ndarray):
    """Solve tridiagonal systems along the last axis.

    Shapes (broadcast-compatible leading batch dims allowed):
      lower: (..., n-1)   sub-diagonal (A[i, i-1] = lower[i-1])
      diag:  (..., n)     main diagonal
      upper: (..., n-1)   super-diagonal (A[i, i+1] = upper[i])
      rhs:   (..., n)

    Same convention as the reference solve_tridiagonal (pde_core.hpp:408-436).
    The scan is over the system axis; every step is a vectorized op over the
    batch, so a (B, n) batch runs as n sequential (B,)-wide ops.
    """
    lower, diag, upper, rhs = map(jnp.asarray, (lower, diag, upper, rhs))
    n = diag.shape[-1]
    batch = jnp.broadcast_shapes(
        lower.shape[:-1], diag.shape[:-1], upper.shape[:-1], rhs.shape[:-1]
    )
    lower = jnp.broadcast_to(lower, batch + (n - 1,))
    diag = jnp.broadcast_to(diag, batch + (n,))
    upper = jnp.broadcast_to(upper, batch + (n - 1,))
    rhs = jnp.broadcast_to(rhs, batch + (n,))

    # move the system axis to the front for scanning: (n, ...batch)
    def front(a):
        return jnp.moveaxis(a, -1, 0)

    lo = front(lower)  # (n-1, B...)
    d = front(diag)  # (n,   B...)
    up = front(upper)  # (n-1, B...)
    b = front(rhs)  # (n,   B...)

    zeros = jnp.zeros_like(d[0])
    up_padded = jnp.concatenate([up, zeros[None]], axis=0)  # upper[n-1] := 0
    lo_padded = jnp.concatenate([zeros[None], lo], axis=0)  # lower[-1]  := 0

    c0 = up_padded[0] / d[0]
    d0 = b[0] / d[0]

    def fwd(carry, x):
        c_prev, dp_prev = carry
        lo_i, d_i, up_i, b_i = x
        m = d_i - lo_i * c_prev
        c_i = up_i / m
        dp_i = (b_i - lo_i * dp_prev) / m
        return (c_i, dp_i), (c_i, dp_i)

    (_, _), (cs, dps) = jax.lax.scan(
        fwd, (c0, d0), (lo_padded[1:], d[1:], up_padded[1:], b[1:])
    )
    cs = jnp.concatenate([c0[None], cs], axis=0)  # (n, B...)
    dps = jnp.concatenate([d0[None], dps], axis=0)

    def bwd(x_next, x):
        c_i, dp_i = x
        x_i = dp_i - c_i * x_next
        return x_i, x_i

    _, xs = jax.lax.scan(bwd, dps[-1], (cs[:-1], dps[:-1]), reverse=True)
    xs = jnp.concatenate([xs, dps[-1][None]], axis=0)
    return jnp.moveaxis(xs, 0, -1)


def gtsv(lower, diag, upper, rhs):
    """Same contract as :func:`thomas`, through ``lax.linalg.tridiagonal_solve``.

    Every system of the batch (including batch axes added by ``vmap``) is
    laid end to end as ONE block-diagonal system — the sub-diagonal is zero
    at each system's first row and the super-diagonal at its last — and
    solved in one call: cuSPARSE ``gtsv2`` on a GPU, LAPACK ``gtsv`` on a
    CPU.  (The library call loops over a batch axis one system at a time,
    so the batch is never handed to it as such.)  Differentiable in the
    right-hand side and the bands.
    """
    lower, diag, upper, rhs = map(jnp.asarray, (lower, diag, upper, rhs))
    n = rhs.shape[-1]
    batch = jnp.broadcast_shapes(
        lower.shape[:-1], diag.shape[:-1], upper.shape[:-1], rhs.shape[:-1]
    )
    dtype = jnp.result_type(lower, diag, upper, rhs)
    zeros = jnp.zeros(batch + (1,), dtype)
    dl = jnp.concatenate(
        [zeros, jnp.broadcast_to(lower, batch + (n - 1,)).astype(dtype)], -1)
    du = jnp.concatenate(
        [jnp.broadcast_to(upper, batch + (n - 1,)).astype(dtype), zeros], -1)
    d = jnp.broadcast_to(diag, batch + (n,)).astype(dtype)
    b = jnp.broadcast_to(rhs, batch + (n,)).astype(dtype)
    return _flat_gtsv(dl, d, du, b)


@jax.custom_vjp
def _flat_gtsv(dl, d, du, b):
    return _flat_gtsv_core(dl, d, du, b)


def _flat_gtsv_fwd(dl, d, du, b):
    x = _flat_gtsv_core(dl, d, du, b)
    return x, (dl, d, du, x)


def _flat_gtsv_bwd(res, x_bar):
    # A x = b  =>  b_bar = A^-T x_bar, and each band's cotangent is
    # -b_bar times the neighbour of x it multiplies
    dl, d, du, x = res
    zero = jnp.zeros_like(x[..., :1])
    dl_t = jnp.concatenate([zero, du[..., :-1]], -1)   # A^T[i, i-1] = A[i-1, i]
    du_t = jnp.concatenate([dl[..., 1:], zero], -1)    # A^T[i, i+1] = A[i+1, i]
    b_bar = _flat_gtsv_core(dl_t, d, du_t, x_bar)
    x_dn = jnp.concatenate([zero, x[..., :-1]], -1)
    x_up = jnp.concatenate([x[..., 1:], zero], -1)
    return -b_bar * x_dn, -b_bar * x, -b_bar * x_up, b_bar


_flat_gtsv.defvjp(_flat_gtsv_fwd, _flat_gtsv_bwd)


@jax.custom_batching.custom_vmap
def _flat_gtsv_core(dl, d, du, b):
    x = jax.lax.linalg.tridiagonal_solve(
        dl.reshape(-1), d.reshape(-1), du.reshape(-1), b.reshape(-1, 1))
    return x.reshape(b.shape)


@_flat_gtsv_core.def_vmap
def _flat_gtsv_vmap(axis_size, in_batched, dl, d, du, b):
    args = [a if bat else jnp.broadcast_to(a, (axis_size,) + a.shape)
            for a, bat in zip((dl, d, du, b), in_batched)]
    return _flat_gtsv_core(*args), True


@jax.jit
def pcr(lower: jnp.ndarray, diag: jnp.ndarray, upper: jnp.ndarray, rhs: jnp.ndarray):
    """Parallel cyclic reduction along the last axis — for LONG single systems.

    Thomas (:func:`thomas`) is optimal when thousands of independent systems
    advance together, but it is O(n) *sequential* in the system dimension;
    with few systems and a very long grid (n >= ~1e4) the device idles.  PCR
    is the data-parallel alternative (SURVEY.md §7 "cyclic-reduction for very
    long single systems"): ceil(log2(n)) rounds, each a fully-vectorized O(n)
    elimination of the odd/even neighbours at stride 1, 2, 4, ..., after
    which every equation is decoupled and x = d / b.  Total work is
    O(n log n) FLOPs — more than Thomas's O(n) — but every round is one
    shifted-add tensor op, so wall-clock is ~log2(n) launches regardless of
    batch width.

    Same shape/signature conventions as :func:`thomas`; broadcastable
    leading batch dims.  Numerically requires diagonal dominance (satisfied
    by the CN/ADI/implicit-obstacle systems this framework builds).
    """
    import math

    lower, diag, upper, rhs = map(jnp.asarray, (lower, diag, upper, rhs))
    n = diag.shape[-1]
    batch = jnp.broadcast_shapes(
        lower.shape[:-1], diag.shape[:-1], upper.shape[:-1], rhs.shape[:-1]
    )
    zero = jnp.zeros(batch + (1,), diag.dtype)
    # row-aligned bands: a[i] multiplies x[i-s], c[i] multiplies x[i+s]
    a = jnp.concatenate([zero, jnp.broadcast_to(lower, batch + (n - 1,))], axis=-1)
    c = jnp.concatenate([jnp.broadcast_to(upper, batch + (n - 1,)), zero], axis=-1)
    b = jnp.broadcast_to(diag, batch + (n,))
    d = jnp.broadcast_to(rhs, batch + (n,))

    def shift_down(x, s):  # value of row i-s, identity rows beyond the edge
        return jnp.concatenate([jnp.zeros(batch + (s,), x.dtype), x[..., :-s]], axis=-1)

    def shift_up(x, s):  # value of row i+s
        return jnp.concatenate([x[..., s:], jnp.zeros(batch + (s,), x.dtype)], axis=-1)

    s = 1
    for _ in range(max(1, math.ceil(math.log2(n)))):
        # neighbour rows at distance s; out-of-range neighbours are the
        # identity equation (b=1, a=c=d=0), which eliminates to a no-op
        b_dn = jnp.where(shift_down(jnp.ones_like(b), s) > 0, shift_down(b, s), 1.0)
        b_up = jnp.where(shift_up(jnp.ones_like(b), s) > 0, shift_up(b, s), 1.0)
        alpha = -a / b_dn
        gamma = -c / b_up
        b = b + alpha * shift_down(c, s) + gamma * shift_up(a, s)
        d = d + alpha * shift_down(d, s) + gamma * shift_up(d, s)
        a = alpha * shift_down(a, s)
        c = gamma * shift_up(c, s)
        if s < n:
            s *= 2
    return d / b


def tridiagonal_solve(lower, diag, upper, rhs):
    """Solve tridiagonal systems along the last axis (shapes as :func:`thomas`).

    Real float32/float64 systems go through :func:`gtsv` — one library call
    for the whole batch, with pivoting; measured on an H100 it marches the
    local-vol and Heston books 3-16x faster than the :func:`thomas` scan,
    whose every row is a dependent step.  Other dtypes use :func:`thomas`.
    """
    rhs = jnp.asarray(rhs)
    dtype = jnp.result_type(lower, diag, upper, rhs)
    if dtype in (jnp.float32, jnp.float64):
        return gtsv(lower, diag, upper, rhs)
    return thomas(lower, diag, upper, rhs)
