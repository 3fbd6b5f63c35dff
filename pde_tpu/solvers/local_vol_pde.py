"""Local-volatility 1D PDE solver (log-space Crank-Nicolson).

Generalizes :mod:`pde_tpu.solvers.bs_pde` (reference counterpart
black_scholes_pde.hpp — constant vol) to a state- and time-dependent
diffusion sigma(S, t):

    V_t + 0.5 sigma(S,t)^2 V_xx + (r - q - 0.5 sigma(S,t)^2) V_x - r V = 0

in x = ln S.  Two routes:

* :func:`solve` — ``lax.scan`` march rebuilding the three diagonals each
  step from ``vol_fn(s_grid, t)``; differentiable end to end (use it for
  adjoint Greeks).
* :func:`solve_fused` / :func:`solve_fused_batch` — the sigma(s, t)
  lattice and ALL per-step operator rows precomputed up front, then the
  whole march inside ONE Pallas kernel (:mod:`pde_tpu.ops.cn1d_tv_fused`).
  Pointwise bilinear lookups of a :class:`SurfaceInterpolator` surface are
  gathers, so the book's lattice is built as two one-hot matrix products
  (:func:`_band_lattice_batch_matmul`) in full float32 precision.
  :func:`solve_batch` is the kernel's plain twin, a lax.scan +
  batched-Thomas march over the same bands.

Paired with :mod:`pde_tpu.models.local_vol` (AD Dupire extraction) this is
the local-vol model family the reference lacks: calibrate Heston/Bates ->
extract sigma_loc by AD -> price path-dependent/American contracts on the
smile-consistent diffusion.  tests/test_local_vol.py closes the loop
(CF vanillas reproduced to ~0.3%).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core import grids
from ..ops.tridiag import thomas, tridiagonal_solve

__all__ = ["LVPDEResult", "solve", "solve_fused", "solve_fused_batch",
           "solve_batch"]


class LVPDEResult(NamedTuple):
    price: jnp.ndarray
    delta: jnp.ndarray
    gamma: jnp.ndarray
    prices: jnp.ndarray     # value on the grid at t=0
    spot_grid: jnp.ndarray
    early_exercise_optimal: jnp.ndarray


def _coeffs(sig, dx, r, q):
    """Per-node operator rows: L = diffusion + advection - r I in log space."""
    sigma2 = sig * sig
    a = 0.5 * sigma2 / (dx * dx)
    b = (r - q - 0.5 * sigma2) / (2.0 * dx)
    return a - b, -2.0 * a - r, a + b  # (L_m, L_c, L_p), each (n,)


def solve(
    vol_fn: Callable,
    S0,
    *,
    K,
    T,
    r=0.0,
    q=0.0,
    is_call=True,
    american: bool = False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
) -> LVPDEResult:
    """Backward CN march under ``sigma = vol_fn(s_grid, t_calendar)``.

    ``vol_fn`` maps (spot-level array (n,), scalar calendar time t in
    [0, T]) -> per-node vols (n,); pass a
    :class:`~pde_tpu.models.local_vol.SurfaceInterpolator` for a Dupire
    surface, or ``lambda s, t: jnp.full_like(s, sig)`` to recover bs_pde
    (regression-tested).  American exercise by per-step projection (the
    bs_pde/reference treatment).  jit-compatible: wrap the call in
    ``jax.jit`` with ``vol_fn`` captured in the closure.
    """
    s_grid = jnp.exp(
        jnp.linspace(jnp.log(K * s_min_mult), jnp.log(K * s_max_mult), n_space)
    )
    dx = jnp.log(s_grid[-1] / s_grid[0]) / (n_space - 1)
    dt = T / n_time
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]

    payoff = jnp.where(
        jnp.asarray(is_call), jnp.maximum(s_grid - K, 0.0),
        jnp.maximum(K - s_grid, 0.0),
    )
    idx = jnp.arange(n_space)
    is_interior = (idx > 0) & (idx < n_space - 1)

    def apply_bc(V, tau):
        # Dirichlet with both discounts over time-to-expiry (the bs_pde
        # corrected convention, not the reference's calendar-time defect)
        df_r = jnp.exp(-r * tau)
        df_q = jnp.exp(-q * tau)
        call_q = jnp.asarray(is_call)
        lo = jnp.where(call_q, 0.0, K * df_r - s_grid[0] * df_q)
        hi = jnp.where(call_q, s_grid[-1] * df_q - K * df_r, 0.0)
        return V.at[0].set(lo).at[-1].set(hi)

    def step(V, tau):
        # implicit side at the new time level (time-to-expiry tau), explicit
        # side at the old one — Rannacher-free CN, same as bs_pde
        sig_new = vol_fn(s_grid, T - tau)
        L_m_n, L_c_n, L_p_n = _coeffs(sig_new, dx, r, q)
        if w < 1.0:
            sig_old = vol_fn(s_grid, jnp.minimum(T - tau + dt, T))
            L_m_o, L_c_o, L_p_o = _coeffs(sig_old, dx, r, q)
            LV = (L_m_o[1:-1] * V[:-2] + L_c_o[1:-1] * V[1:-1]
                  + L_p_o[1:-1] * V[2:])
            rhs = V.at[1:-1].add((1.0 - w) * dt * LV)
        else:
            rhs = V
        diag = jnp.where(is_interior, 1.0 - w * dt * L_c_n, 1.0)
        lower = jnp.where(is_interior[1:], -w * dt * L_m_n[1:], 0.0)
        upper = jnp.where(is_interior[:-1], -w * dt * L_p_n[:-1], 0.0)
        V = tridiagonal_solve(lower, diag, upper, rhs)
        V = apply_bc(V, tau)
        if american:
            V = jnp.maximum(V, payoff)
        return V, None

    taus = dt * jnp.arange(1, n_time + 1, dtype=s_grid.dtype)
    V, _ = jax.lax.scan(step, payoff, taus)

    price = grids.interp_linear(s_grid, V, S0)
    i = jnp.clip(grids.find_index(s_grid, S0), 1, n_space - 2)
    delta = (V[i + 1] - V[i - 1]) / (s_grid[i + 1] - s_grid[i - 1])
    davg = 0.5 * (s_grid[i + 1] - s_grid[i - 1])
    gamma = (V[i + 1] - 2.0 * V[i] + V[i - 1]) / (davg * davg)
    payoff_s0 = jnp.where(
        jnp.asarray(is_call), jnp.maximum(S0 - K, 0.0),
        jnp.maximum(K - S0, 0.0),
    )
    early_ex = jnp.asarray(american) & (price > payoff_s0 + 1e-10)
    return LVPDEResult(price, delta, gamma, V, s_grid, early_ex)


def _extract(V, s_grid, S0, K, is_call, american, n_space):
    """Price/delta/gamma at S0 from the t=0 lattice (same stencils as
    :func:`solve`)."""
    price = grids.interp_linear(s_grid, V, S0)
    i = jnp.clip(grids.find_index(s_grid, S0), 1, n_space - 2)
    delta = (V[i + 1] - V[i - 1]) / (s_grid[i + 1] - s_grid[i - 1])
    davg = 0.5 * (s_grid[i + 1] - s_grid[i - 1])
    gamma = (V[i + 1] - 2.0 * V[i] + V[i - 1]) / (davg * davg)
    payoff_s0 = jnp.where(
        jnp.asarray(is_call), jnp.maximum(S0 - K, 0.0),
        jnp.maximum(K - S0, 0.0),
    )
    early_ex = jnp.asarray(american) & (price > payoff_s0 + 1e-10)
    return LVPDEResult(price, delta, gamma, V, s_grid, early_ex)


def _band_lattice_batch_matmul(interp, sg, dx, T, r, q, n_time):
    """Whole-book sigma lattice as TWO one-hot matrix products — no gathers.

    The generic route (vmap of :func:`_band_lattice`) evaluates the
    surface pointwise: ~5M bilinear lookups for a 256-option 200x100 book,
    each a searchsorted + four scattered 2D gathers.  Bilinear
    interpolation IS a sparse linear map, so build the two-nonzeros-per-row
    weight matrices densely (one-hot comparisons) and contract:

        vols_t = Wt @ vols        (B, nT+1, n_T) @ (n_T, n_K)
        sigma  = Wx @ vols_t^T    (B, n, n_K)    @ (B, n_K, nT+1)

    Both contractions pin ``Precision.HIGHEST``: a GPU may otherwise run a
    float32 product in TF32, which rounds the vols to about three digits.
    Matches the pointwise interpolator to f32 round-off (same clamping
    semantics).
    """
    f32 = sg.dtype
    n, B = sg.shape
    log_k = interp.log_k                     # (n_K,)
    tt = interp.t                            # (n_T,)
    vols = interp.vols                       # (n_T, n_K)
    n_k = log_k.shape[0]
    n_t = tt.shape[0]

    dt_b = T / n_time                        # (B,)
    j = jnp.arange(n_time + 1, dtype=f32)
    t_lv = jnp.clip(T[:, None] - dt_b[:, None] * j[None, :], 0.0,
                    T[:, None])              # (B, nT+1)

    # time bracket + weight (flat clamp outside the pillars)
    it = jnp.clip(
        jnp.sum((t_lv[..., None] >= tt[None, None, :]).astype(jnp.int32),
                axis=-1) - 1, 0, n_t - 2)    # (B, nT+1)
    wt = jnp.clip(
        (t_lv - tt[it]) / (tt[it + 1] - tt[it]), 0.0, 1.0)
    kr = jnp.arange(n_t)
    Wt = ((kr == it[..., None]).astype(f32) * (1.0 - wt[..., None])
          + (kr == (it + 1)[..., None]).astype(f32) * wt[..., None])
    hi = jax.lax.Precision.HIGHEST
    vols_t = jnp.einsum("bjk,kx->bjx", Wt, vols.astype(f32),
                        precision=hi)                         # (B,nT+1,n_K)

    # strike bracket + weight — per (option, node), shared across levels
    xq = jnp.log(sg).T                        # (B, n)
    ixk = jnp.clip(
        jnp.sum((xq[..., None] >= log_k[None, None, :]).astype(jnp.int32),
                axis=-1) - 1, 0, n_k - 2)     # (B, n)
    wx = jnp.clip(
        (xq - log_k[ixk]) / (log_k[ixk + 1] - log_k[ixk]), 0.0, 1.0)
    xr = jnp.arange(n_k)
    Wx = ((xr == ixk[..., None]).astype(f32) * (1.0 - wx[..., None])
          + (xr == (ixk + 1)[..., None]).astype(f32) * wx[..., None])
    sig = jnp.einsum("bnx,bjx->jnb", Wx, vols_t, precision=hi)  # (nT+1,n,B)

    L_m, L_c, L_p = _coeffs(sig, dx, r, q)
    return jnp.concatenate([L_m, L_c, L_p], axis=1)           # (nT+1,3n,B)


def _book_bands(vol_fn, sg, dx, T, r, q, n_time):
    """Book band lattice: the matrix-product route for
    :class:`SurfaceInterpolator` surfaces, the generic vmapped route for
    arbitrary callables."""
    from ..models.local_vol import SurfaceInterpolator

    if isinstance(vol_fn, SurfaceInterpolator):
        return _band_lattice_batch_matmul(vol_fn, sg, dx, T, r, q, n_time)
    return jax.vmap(
        lambda sgb, Tb: _band_lattice(vol_fn, sgb, dx, Tb, r, q, n_time),
        in_axes=(1, 0), out_axes=2,
    )(sg, T)


def _band_lattice(vol_fn, s_grid, dx, T, r, q, n_time):
    """Operator rows for ALL time levels as one tensor op.

    Level j corresponds to calendar time T - j*dt (j = 0 is expiry, the
    first step's explicit side); the fused march's step k reads levels k
    (explicit) and k+1 (implicit).  The whole sigma(s, t) lattice
    evaluates in one vmapped interpolation call instead of once per scan
    step — this is the "precompute the diagonals outside the march" half
    of the speedup; the fused kernel is the other half."""
    dt = T / n_time
    t_levels = T - dt * jnp.arange(n_time + 1, dtype=s_grid.dtype)
    t_levels = jnp.clip(t_levels, 0.0, T)
    sig = jax.vmap(lambda t: vol_fn(s_grid, t))(t_levels)  # (nT+1, n)
    L_m, L_c, L_p = _coeffs(sig, dx, r, q)                 # each (nT+1, n)
    return jnp.concatenate([L_m, L_c, L_p], axis=-1)       # (nT+1, 3n)


def solve_fused(
    vol_fn: Callable,
    S0,
    *,
    K,
    T,
    r=0.0,
    q=0.0,
    is_call=True,
    american: bool = False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
    interpret: bool = False,
) -> LVPDEResult:
    """:func:`solve` through the fused time-varying march kernel
    (:func:`pde_tpu.ops.cn1d_tv_fused.fused_cn_march_1d_tv`), as the
    one-option view of :func:`solve_fused_batch`.

    Agrees with :func:`solve` to f32 accumulation tolerance
    (regression-tested); keep :func:`solve` for AD (adjoint Greeks
    differentiate the scan, not the kernel).  ``interpret=True`` runs the
    kernel in the Pallas interpreter (CPU tests).
    """
    res = solve_fused_batch(
        vol_fn, S0, K=K, T=T, r=r, q=q, is_call=is_call,
        american=american, n_space=n_space, n_time=n_time,
        s_min_mult=s_min_mult, s_max_mult=s_max_mult, scheme=scheme,
        interpret=interpret,
    )
    # single-option view of the B=1 batch result (the batch path gets the
    # matrix-product lattice builder)
    return LVPDEResult(
        res.price[0], res.delta[0], res.gamma[0], res.prices[0],
        res.spot_grid[0], res.early_exercise_optimal[0])


def _book(S0, K, T, is_call, american):
    """Broadcast the per-option inputs of a book along one batch axis."""
    f32 = jnp.float32
    arrs = (jnp.atleast_1d(jnp.asarray(S0, f32)),
            jnp.atleast_1d(jnp.asarray(K, f32)),
            jnp.atleast_1d(jnp.asarray(T, f32)),
            jnp.atleast_1d(jnp.asarray(is_call)).astype(f32),
            jnp.atleast_1d(jnp.asarray(american)).astype(f32))
    B = max(a.shape[0] for a in arrs)
    return tuple(jnp.broadcast_to(a, (B,)) for a in arrs)


def solve_fused_batch(
    vol_fn: Callable,
    S0,
    *,
    K,
    T,
    r=0.0,
    q=0.0,
    is_call=True,
    american=False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
    interpret: bool = False,
) -> LVPDEResult:
    """A whole option BOOK on one local-vol surface through ONE fused
    march kernel, float32.

    ``K``/``T``/``is_call``/``american`` broadcast along one leading batch
    axis (mixed strikes, maturities, calls/puts, European/American); each
    option gets its own K-scaled grid and its own dt = T_b/n_time, and the
    per-option sigma(s, t) lattices evaluate as one call.  The reference
    prices such books one C++ solve at a time (black_scholes_pde.hpp:97-147
    per option, generalized march 234-274).  :func:`solve_batch` is the
    plain XLA twin the kernel is tested and measured against.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    S0_b, K_b, T_b, call_b, amer_b = _book(S0, K, T, is_call, american)
    return _solve_fused_batch_impl(
        vol_fn, S0_b, K_b, T_b, r, q, call_b, amer_b,
        n_space, n_time, s_min_mult, s_max_mult, scheme, interpret,
    )


def solve_batch(
    vol_fn: Callable,
    S0,
    *,
    K,
    T,
    r=0.0,
    q=0.0,
    is_call=True,
    american=False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
) -> LVPDEResult:
    """:func:`solve_fused_batch` as plain XLA: the same bands and step
    math, the time loop a ``lax.scan`` over batched Thomas solves."""
    S0_b, K_b, T_b, call_b, amer_b = _book(S0, K, T, is_call, american)
    return _solve_batch_scan_impl(
        vol_fn, S0_b, K_b, T_b, r, q, call_b, amer_b,
        n_space, n_time, s_min_mult, s_max_mult, scheme,
    )


@functools.partial(
    jax.jit,
    static_argnames=("vol_fn", "n_space", "n_time", "s_min_mult",
                     "s_max_mult", "scheme", "interpret"),
)
def _solve_fused_batch_impl(vol_fn, S0, K, T, r, q, call_f, amer_f,
                            n_space, n_time, s_min_mult, s_max_mult,
                            scheme, interpret):
    from ..ops.cn1d_tv_fused import fused_cn_march_1d_tv
    import math

    f32 = jnp.float32
    n, B = n_space, K.shape[0]
    # K-scaled log-moneyness grid shared across the book: dx is
    # option-independent, the per-option spot grid is K_b * exp(x)
    x = jnp.linspace(math.log(s_min_mult), math.log(s_max_mult), n, dtype=f32)
    dx = (math.log(s_max_mult) - math.log(s_min_mult)) / (n - 1)
    ex = jnp.exp(x)
    sg = ex[:, None] * K[None, :]                       # (n, B)
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]

    pay = jnp.where(
        call_f[None, :] > 0.5,
        jnp.maximum(ex - 1.0, 0.0)[:, None] * K[None, :],
        jnp.maximum(1.0 - ex, 0.0)[:, None] * K[None, :],
    )

    bands = _book_bands(vol_fn, sg, dx, T, r, q, n_time)
    sc = jnp.stack([
        T / n_time, jnp.full((B,), r, f32), jnp.full((B,), q, f32), K,
        call_f, amer_f, sg[0, :], sg[-1, :],
    ])

    with jax.named_scope("local_vol_fused_march"):
        V = fused_cn_march_1d_tv(
            pay, bands, sc, n_space=n_space, n_time=n_time, w=w,
            interpret=interpret,
        )                                               # (n, B)

    res = jax.vmap(
        lambda Vb, sgb, S0b, Kb, cb, ab: _extract(
            Vb, sgb, S0b, Kb, cb > 0.5, ab > 0.5, n_space
        )
    )(V.T, sg.T, S0, K, call_f, amer_f)
    return res


@functools.partial(
    jax.jit,
    static_argnames=("vol_fn", "n_space", "n_time", "s_min_mult",
                     "s_max_mult", "scheme"),
)
def _solve_batch_scan_impl(vol_fn, S0, K, T, r, q, call_f, amer_f,
                           n_space, n_time, s_min_mult, s_max_mult, scheme):
    """Precomputed-bands scan march: the twin behind :func:`solve_batch`.

    Same math as the fused kernel (`_solve_fused_batch_impl`) but the time
    loop is a `lax.scan` whose per-step
    tridiagonal solves go through the batched Thomas (`ops.tridiag.thomas`,
    options on the leading batch axis).  The whole sigma(s, t) lattice and
    all per-step operator rows still build as ONE tensor op before the
    march — the scan streams them as xs.
    """
    import math

    f32 = jnp.float32
    n, B = n_space, K.shape[0]
    x = jnp.linspace(math.log(s_min_mult), math.log(s_max_mult), n, dtype=f32)
    dx = (math.log(s_max_mult) - math.log(s_min_mult)) / (n - 1)
    ex = jnp.exp(x)
    sg = ex[:, None] * K[None, :]                       # (n, B)
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]

    pay = jnp.where(
        call_f[None, :] > 0.5,
        jnp.maximum(ex - 1.0, 0.0)[:, None] * K[None, :],
        jnp.maximum(1.0 - ex, 0.0)[:, None] * K[None, :],
    )

    bands = _book_bands(vol_fn, sg, dx, T, r, q, n_time)
    bands = bands.reshape(n_time + 1, 3, n, B)
    dts = (T / n_time).astype(f32)                      # (B,)

    ar = jnp.arange(n, dtype=f32)[:, None]
    m0 = (ar == 0).astype(f32)
    mN = (ar == n - 1).astype(f32)
    mi = ((ar > 0) & (ar < n - 1)).astype(f32)
    r_f = jnp.asarray(r, f32)
    q_f = jnp.asarray(q, f32)

    def step(V, xs):
        bo, bn, tau = xs                               # (3,n,B), (3,n,B), (B,)
        Lmo, Lco, Lpo = bo[0], bo[1], bo[2]
        Lmn, Lcn, Lpn = bn[0], bn[1], bn[2]
        Vd = jnp.concatenate([jnp.zeros((1, B), f32), V[:-1]])
        Vu = jnp.concatenate([V[1:], jnp.zeros((1, B), f32)])
        LV = Lmo * Vd + Lco * V + Lpo * Vu
        rhs = V + ((1.0 - w) * dts) * (mi * LV)
        li = mi * (-(w * dts) * Lmn)
        di = mi * (1.0 - (w * dts) * Lcn) + (1.0 - mi)
        ui = mi * (-(w * dts) * Lpn)
        Vn = thomas(li[1:].T, di.T, ui[:-1].T, rhs.T).T
        dfr = jnp.exp(-r_f * tau)
        dfq = jnp.exp(-q_f * tau)
        bc0 = (1.0 - call_f) * (K * dfr - sg[0, :] * dfq)
        bcN = call_f * (sg[-1, :] * dfq - K * dfr)
        Vn = Vn * (1.0 - m0) + bc0[None, :] * m0
        Vn = Vn * (1.0 - mN) + bcN[None, :] * mN
        Vn = Vn + amer_f[None, :] * (jnp.maximum(Vn, pay) - Vn)
        return Vn, None

    taus = dts[None, :] * jnp.arange(1, n_time + 1, dtype=f32)[:, None]
    V, _ = jax.lax.scan(step, pay, (bands[:-1], bands[1:], taus))

    res = jax.vmap(
        lambda Vb, sgb, S0b, Kb, cb, ab: _extract(
            Vb, sgb, S0b, Kb, cb > 0.5, ab > 0.5, n_space
        )
    )(V.T, sg.T, S0, K, call_f, amer_f)
    return res
