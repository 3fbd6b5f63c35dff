"""Heston 2D PDE solver — Douglas ADI in log-spot coordinates.

Covers the role of the reference HestonPDESolver
(src/cpp/solvers/heston_pde.hpp) — 2D (S, v) finite differences, ADI
splitting with the mixed derivative explicit, per-step ``max(V, payoff)`` for
American exercise — but is a ground-up redesign, for two reasons:

**Correctness.** The reference scheme converges to a biased price (~6% high
for the canonical test set heston.cpp uses): its linear-extrapolation
boundary at both v edges (heston_pde.hpp:471-478) and its S_max condition
without the dividend discount (heston_pde.hpp:462-467) contaminate the
interior.  This was established by grid-refinement against the true price
from three independent methods (adaptive Carr-Madan quadrature, the Heston
P1/P2 representation, and the FFT pricer).  This solver instead uses
In 't Hout & Foulon (2010) boundary treatment:

* v = 0 is a PDE row: V_t + (r-q)S V_S + kappa*theta*V_v - rV = 0 with a
  one-sided difference for V_v (the diffusion vanishes at v = 0);
* v = v_max: Dirichlet V = S e^{-q tau} (call) / K e^{-r tau} (put);
* S boundaries: Dirichlet with both discounts, V(S_max) = S_max e^{-q tau}
  - K e^{-r tau}.

Validated: 100x50x100 grid prices the canonical ATM call to 0.17% of truth
(the reference: 5.5%), converging under refinement.

**Device shape.**  Log-spot coordinates make the S operator
constant-coefficient per v level (uniform dx); all nv implicit S systems
solve as ONE batched Thomas call, all nS v systems likewise (the v operator
is S-independent, one set of diagonals broadcast over rows); the time march
is a ``lax.scan``.  All model/contract inputs (kappa..v0, r, q, T, K,
is_call, S0) are TRACED, so :func:`solve_batch` vmaps whole option surfaces
— mixed strikes, maturities, parameters, calls and puts — through one
compiled march, and the batch axis shards over the ``dp`` mesh axis for
multi-device pricing.  :func:`solve_fused_batch` runs the same march for a
whole book inside one Pallas kernel (:mod:`pde_tpu.ops.adi_fused`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import grids
from ..ops.tridiag import thomas_factor, thomas_solve_factored

__all__ = [
    "HestonPDEParams",
    "HestonPDEResult",
    "solve",
    "solve_fused",
    "solve_batch",
    "solve_fused_batch",
    "greeks_ad",
]


class HestonPDEParams(NamedTuple):
    """Inputs (grid defaults match the reference, heston_pde.hpp:56-61)."""

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
    n_spot: int = 100
    n_vol: int = 50
    n_time: int = 100
    s_min_mult: float = 0.2
    s_max_mult: float = 5.0
    v_max: float = 1.0
    # American exercise: "projection" = per-step max(V, payoff) (the
    # reference's splitting, heston_pde.hpp:143-150); "it_lcp" = Ikonen-
    # Toivanen operator splitting with an explicit exercise-premium
    # multiplier — the rigorous LCP treatment for ADI schemes
    american_method: str = "projection"
    # ADI splitting family: "douglas" (default; this build's scheme),
    # "craig_sneyd" — the reference's family (explicit mixed step + second
    # corrector pass, heston_pde.hpp:245-248) — or "hv"
    # (Hundsdorfer-Verwer: full-operator corrector with the second sweep
    # pair anchored at the predictor; second-order including the mixed
    # term, the strongest damping of the three).  Identical stable limits
    # for these coefficients; CS/HV cost one extra pair of implicit sweeps
    # per step for formally better time accuracy on the mixed term.
    scheme: str = "douglas"


class HestonPDEResult(NamedTuple):
    price: jnp.ndarray
    delta: jnp.ndarray
    gamma: jnp.ndarray
    vega: jnp.ndarray
    theta: jnp.ndarray
    prices: jnp.ndarray  # V(S, v) at t=0
    spot_grid: jnp.ndarray
    vol_grid: jnp.ndarray


def _a1_diags(v_grid, dx, r, q):
    """S-direction (log-coordinate) operator rows for every v level.

    A1 = 0.5 v V_xx + (r - q - 0.5 v) V_x - 0.5 r V on interior rows;
    boundary rows are zero (Dirichlet values are reimposed each step).
    Returns (lower, diag, upper) with shapes (nv, nS-1), (nv, nS), (nv, nS-1)
    ready to batch over the v axis.
    """
    a = 0.5 * v_grid / (dx * dx)  # (nv,)
    b = (r - q - 0.5 * v_grid) / (2.0 * dx)
    lo_val = (a - b)[:, None]
    di_val = (-2.0 * a - 0.5 * r)[:, None]
    up_val = (a + b)[:, None]
    return lo_val, di_val, up_val  # interior coefficient values, constant per row


def _a2_diags(v_grid, dv, kappa, theta, sigma, r):
    """v-direction operator (identical for every S row).

    Interior: 0.5 sigma^2 v V_vv + kappa(theta - v) V_v - 0.5 r V.  The
    convection term is central where the scheme stays an M-matrix
    (diffusion >= |convection| * dv / 2) and first-order upwind at nodes
    where it would not — without this, convection-dominated regimes (small
    vol-of-vol, large kappa, the far-v region) feed central-differencing
    oscillations through the whole surface (observed: a 200x60 grid pricing
    an ATM call at -0.94 with sigma = 0.01).
    v = 0 row: kappa*theta * one-sided V_v - 0.5 r V.
    v = v_max row: zero (Dirichlet).
    Returns dense diagonals of shape (nv-1,), (nv,), (nv-1,).
    """
    nv = v_grid.shape[0]
    vj = v_grid[1:-1]
    d = 0.5 * sigma * sigma * vj / (dv * dv)
    adv = kappa * (theta - vj) / (2.0 * dv)

    central_ok = d >= jnp.abs(adv)
    up = adv > 0.0  # convection pushes toward larger v
    lo_j = jnp.where(central_ok, d - adv, jnp.where(up, d, d - 2.0 * adv))
    up_j = jnp.where(central_ok, d + adv, jnp.where(up, d + 2.0 * adv, d))
    di_j = -(lo_j + up_j)  # row sum zero before the -r/2 discount term

    lower = jnp.zeros(nv - 1).at[:-1].set(lo_j)
    diag = jnp.zeros(nv).at[1:-1].set(di_j - 0.5 * r)
    upper = jnp.zeros(nv - 1).at[1:].set(up_j)

    # v = 0 boundary row: first-order one-sided convection (diffusion is 0)
    c = kappa * theta / dv
    diag = diag.at[0].set(-c - 0.5 * r)
    upper = upper.at[0].set(c)
    # v = v_max: Dirichlet row stays zero
    return lower, diag, upper


def _assemble_a1(nS, nv, lo_val, di_val, up_val):
    """Expand per-level constants into batched tridiagonals (nv, nS*)."""
    interior = ((jnp.arange(nS) > 0) & (jnp.arange(nS) < nS - 1)).astype(lo_val.dtype)
    lower = jnp.broadcast_to(lo_val, (nv, nS - 1)) * interior[1:]
    diag = jnp.broadcast_to(di_val, (nv, nS)) * interior
    upper = jnp.broadcast_to(up_val, (nv, nS - 1)) * interior[:-1]
    return lower, diag, upper


def _apply_a1(V, lower, diag, upper):
    """A1 V with the batched-diagonal representation (systems along axis 0 of V)."""
    out = diag.T * V
    out = out.at[1:, :].add(lower.T * V[:-1, :])
    out = out.at[:-1, :].add(upper.T * V[1:, :])
    return out


def _apply_a2(V, lower, diag, upper):
    """A2 V, acting along the v axis (axis 1); same diagonals for all rows."""
    out = V * diag[None, :]
    out = out.at[:, 1:].add(V[:, :-1] * lower[None, :])
    out = out.at[:, :-1].add(V[:, 1:] * upper[None, :])
    return out


def _apply_a0(V, v_grid, dx, dv, rho, sigma):
    """Mixed-derivative term rho sigma v V_xv (explicit only)."""
    V_xv = (V[2:, 2:] - V[2:, :-2] - V[:-2, 2:] + V[:-2, :-2]) / (4.0 * dx * dv)
    out = rho * sigma * v_grid[None, 1:-1] * V_xv
    return jnp.pad(out, ((1, 1), (1, 1)))


def _solve_core(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    *,
    american: bool,
    american_method: str,
    n_spot: int,
    n_vol: int,
    n_time: int,
    s_min_mult: float,
    s_max_mult: float,
    v_max: float,
    remat: bool = False,
    scheme: str = "douglas",
):
    """The march with every model/contract input TRACED (only grid sizes and
    the American mode are static) — the vmap/shard-able core."""
    nS, nv, nT = n_spot, n_vol, n_time
    is_call = jnp.asarray(is_call)
    x = jnp.linspace(jnp.log(K * s_min_mult), jnp.log(K * s_max_mult), nS)
    s_grid = jnp.exp(x)
    dx = (x[-1] - x[0]) / (nS - 1)
    v_grid = jnp.linspace(0.0, v_max, nv)
    dv = v_max / (nv - 1)
    dt = T / nT
    th = 0.5  # Douglas parameter

    payoff_1d = jnp.where(
        is_call, jnp.maximum(s_grid - K, 0.0), jnp.maximum(K - s_grid, 0.0)
    )
    payoff = jnp.broadcast_to(payoff_1d[:, None], (nS, nv))

    lo_v, di_v, up_v = _a1_diags(v_grid, dx, r, q)
    a1_lower, a1_diag, a1_upper = _assemble_a1(nS, nv, lo_v, di_v, up_v)
    a2_lower, a2_diag, a2_upper = _a2_diags(v_grid, dv, kappa, theta, sigma, r)

    # implicit system diagonals (I - th dt A)
    i1_lower = -th * dt * a1_lower
    i1_diag = 1.0 - th * dt * a1_diag
    i1_upper = -th * dt * a1_upper
    i2_lower = -th * dt * a2_lower
    i2_diag = 1.0 - th * dt * a2_diag
    i2_upper = -th * dt * a2_upper

    def apply_bc(V, tau):
        """Dirichlet boundaries at time-to-expiry tau (In 't Hout-Foulon)."""
        df_r = jnp.exp(-r * tau)
        df_q = jnp.exp(-q * tau)
        V = V.at[0, :].set(jnp.where(is_call, 0.0, K * df_r - s_grid[0] * df_q))
        V = V.at[-1, :].set(jnp.where(is_call, s_grid[-1] * df_q - K * df_r, 0.0))
        V = V.at[:, -1].set(jnp.where(is_call, s_grid * df_q, K * df_r))
        return V

    # both sweep operators are time-independent: Thomas-factorize once so
    # every step's serial chains are multiply/fma-only
    i1_factors = thomas_factor(i1_lower, i1_diag, i1_upper)
    i2_factors = thomas_factor(i2_lower, i2_diag, i2_upper)

    def _sweeps(Y0, a1V, a2V):
        rhs1 = Y0 - th * dt * a1V
        Y1 = thomas_solve_factored(i1_factors, rhs1.T).T
        rhs2 = Y1 - th * dt * a2V
        return thomas_solve_factored(i2_factors, rhs2)

    def adi_step(V, source):
        """Douglas splitting: explicit full step, then implicit x and v
        sweeps; Craig-Sneyd adds a mixed-term corrector + second sweep pair
        (the reference's family, heston_pde.hpp:245-248).

        ``source`` carries the Ikonen-Toivanen exercise-premium multiplier
        (zero for European / projection mode)."""
        a0V = _apply_a0(V, v_grid, dx, dv, rho, sigma)
        a1V = _apply_a1(V, a1_lower, a1_diag, a1_upper)
        a2V = _apply_a2(V, a2_lower, a2_diag, a2_upper)
        Y0 = V + dt * (a0V + a1V + a2V + source)

        Y2 = _sweeps(Y0, a1V, a2V)
        if scheme == "craig_sneyd":
            # corrector: re-evaluate the EXPLICIT (mixed) operator at the
            # predictor and redo both implicit sweeps (lambda = 1/2)
            a0Y = _apply_a0(Y2, v_grid, dx, dv, rho, sigma)
            Y0_tilde = Y0 + 0.5 * dt * (a0Y - a0V)
            Y2 = _sweeps(Y0_tilde, a1V, a2V)
        elif scheme == "hv":
            # Hundsdorfer-Verwer: re-evaluate the FULL operator at the
            # predictor (mu = 1/2) and run the second implicit sweep pair
            # anchored at the predictor, not at V — second-order in time
            # including the mixed term, with stronger damping than
            # Craig-Sneyd (In 't Hout & Foulon 2010, scheme (2.9))
            a0Y = _apply_a0(Y2, v_grid, dx, dv, rho, sigma)
            a1Y = _apply_a1(Y2, a1_lower, a1_diag, a1_upper)
            a2Y = _apply_a2(Y2, a2_lower, a2_diag, a2_upper)
            Y0_tilde = Y0 + 0.5 * dt * (
                (a0Y + a1Y + a2Y) - (a0V + a1V + a2V)
            )
            Y2 = _sweeps(Y0_tilde, a1Y, a2Y)
        return Y2

    use_it = american and american_method == "it_lcp"

    def step(carry, tau):
        V, lam = carry
        Vt = adi_step(V, lam)
        if use_it:
            # Ikonen-Toivanen update: find (V_new, lam_new) with
            # V_new - dt lam_new = Vt - dt lam, V_new >= g, lam_new >= 0,
            # lam_new (V_new - g) = 0
            W = Vt - dt * lam
            V_new = jnp.maximum(payoff, W)
            lam = (V_new - W) / dt
            Vt = V_new
        Vt = apply_bc(Vt, tau)
        if american and not use_it:
            Vt = jnp.maximum(Vt, payoff)
        if use_it:
            # the Dirichlet/extrapolation boundaries are European; an
            # American value can never fall below intrinsic there
            Vt = Vt.at[0, :].set(jnp.maximum(Vt[0, :], payoff[0, :]))
            Vt = Vt.at[-1, :].set(jnp.maximum(Vt[-1, :], payoff[-1, :]))
            Vt = Vt.at[:, 0].set(jnp.maximum(Vt[:, 0], payoff[:, 0]))
            Vt = Vt.at[:, -1].set(jnp.maximum(Vt[:, -1], payoff[:, -1]))
        return (Vt, lam), None

    taus = dt * jnp.arange(1, nT + 1, dtype=s_grid.dtype)
    # remat: recompute each ADI step on the backward pass instead of saving
    # all nT grids — O(1) activation memory for adjoint Greeks on big grids
    step_fn = jax.checkpoint(step) if remat else step
    (V, _), _ = jax.lax.scan(step_fn, (payoff, jnp.zeros_like(payoff)), taus)

    price = grids.interp_bilinear(s_grid, v_grid, V, S0, v0)

    i = jnp.clip(grids.find_index(s_grid, S0), 1, nS - 2)
    j = jnp.clip(grids.find_index(v_grid, v0), 1, nv - 2)
    delta = (V[i + 1, j] - V[i - 1, j]) / (s_grid[i + 1] - s_grid[i - 1])
    dS_m = s_grid[i] - s_grid[i - 1]
    dS_p = s_grid[i + 1] - s_grid[i]
    davg = 0.5 * (dS_m + dS_p)
    gamma = (V[i + 1, j] - 2.0 * V[i, j] + V[i - 1, j]) / (davg * davg)
    dV_dv = (V[i, j + 1] - V[i, j - 1]) / (2.0 * dv)
    # vega ~ 2 sqrt(v0) T dV/dv (chain rule, same convention as the reference
    # heston_pde.hpp:534-547)
    vega = 2.0 * jnp.sqrt(v0) * T * dV_dv
    theta_g = -(
        _apply_a0(V, v_grid, dx, dv, rho, sigma)
        + _apply_a1(V, a1_lower, a1_diag, a1_upper)
        + _apply_a2(V, a2_lower, a2_diag, a2_upper)
    )[i, j]

    return HestonPDEResult(price, delta, gamma, vega, theta_g, V, s_grid, v_grid)


@functools.partial(
    jax.jit,
    static_argnames=(
        "american", "american_method", "n_spot", "n_vol", "n_time",
        "s_min_mult", "s_max_mult", "v_max", "scheme",
    ),
)
def _solve_impl(kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, *,
                american, american_method, n_spot, n_vol, n_time,
                s_min_mult, s_max_mult, v_max, scheme="douglas"):
    # every model/contract input is TRACED (only grid sizes and the American
    # mode are static) — repricing with new parameters reuses the compiled
    # march instead of paying a multi-second XLA compile per quote
    return _solve_core(
        kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
        american=american, american_method=american_method,
        n_spot=n_spot, n_vol=n_vol, n_time=n_time,
        s_min_mult=s_min_mult, s_max_mult=s_max_mult, v_max=v_max,
        scheme=scheme,
    )


def _validate_params(params: HestonPDEParams) -> None:
    if params.kappa <= 0 or params.theta <= 0 or params.sigma <= 0:
        raise ValueError("kappa, theta, sigma must be positive")
    if abs(params.rho) >= 1:
        raise ValueError("|rho| must be < 1")
    if params.v0 <= 0 or params.T <= 0 or params.K <= 0:
        raise ValueError("v0, T, K must be positive")
    if params.scheme not in ("douglas", "craig_sneyd", "hv"):
        raise ValueError(f"unknown ADI scheme {params.scheme!r}")


def solve(params: HestonPDEParams, S0) -> HestonPDEResult:
    """Solve the Heston PDE; price/Greeks at (S0, v0).

    jit-compiled with only grid sizes/American mode static, so repricing
    with new model parameters reuses the compiled march; vmap over S0 for
    batches, or use :func:`solve_batch` to batch over ALL inputs.
    """
    _validate_params(params)
    return _solve_impl(
        params.kappa, params.theta, params.sigma, params.rho, params.v0,
        params.r, params.q, params.T, params.K, params.is_call, S0,
        american=params.american, american_method=params.american_method,
        n_spot=params.n_spot, n_vol=params.n_vol, n_time=params.n_time,
        s_min_mult=params.s_min_mult, s_max_mult=params.s_max_mult,
        v_max=params.v_max, scheme=params.scheme,
    )


def solve_fused(params: HestonPDEParams, S0, interpret: bool = False) -> HestonPDEResult:
    """:func:`solve` through the fused march kernel: the one-option view of
    :func:`solve_fused_batch` (one option cannot fill a GPU; price books
    with the batch call).

    European and American in both projection and Ikonen-Toivanen modes,
    Douglas scheme only; autodiff stays on :func:`solve`.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    if params.american and params.american_method not in ("projection", "it_lcp"):
        raise ValueError(
            "solve_fused supports american_method 'projection' or 'it_lcp'"
        )
    if params.scheme != "douglas":
        raise ValueError("the fused kernel implements the Douglas scheme; "
                         "use solve() for craig_sneyd")
    _validate_params(params)
    p = params
    res = solve_fused_batch(
        p.kappa, p.theta, p.sigma, p.rho, p.v0, p.r, p.q, p.T, p.K,
        float(bool(p.is_call)), S0, american=float(bool(p.american)),
        american_method=p.american_method, n_spot=p.n_spot, n_vol=p.n_vol,
        n_time=p.n_time, s_min_mult=p.s_min_mult, s_max_mult=p.s_max_mult,
        v_max=p.v_max, interpret=interpret,
    )
    return HestonPDEResult(*(a[0] for a in res))


@functools.partial(
    jax.jit,
    static_argnames=(
        "american", "american_method", "n_spot", "n_vol", "n_time",
        "s_min_mult", "s_max_mult", "v_max", "remat",
    ),
)
def greeks_ad(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american: bool = False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
    remat: bool = False,
):
    """Adjoint (reverse-mode AD) sensitivities through the full ADI march.

    One backward pass differentiates the whole time march — price plus
    NINE exact sensitivities (delta and d/d{kappa, theta, sigma, rho, v0,
    r, q, T}) for ~2x the cost of a forward solve (AD delta matches
    central differences to 4 digits).  The reference bumps the grid once per Greek (heston_pde.hpp:520-560) —
    first-order error and a full re-solve each.  ``remat=True`` recomputes
    steps on the backward pass (O(1) activation memory) for very large
    grids.  Returns a dict: price, delta, and d_<param> entries.
    """
    core = functools.partial(
        _solve_core,
        american=american, american_method=american_method,
        n_spot=n_spot, n_vol=n_vol, n_time=n_time,
        s_min_mult=s_min_mult, s_max_mult=s_max_mult, v_max=v_max,
        remat=remat,
    )

    def price_fn(kappa, theta, sigma, rho, v0, r, q, T, S0):
        return core(kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0).price

    price, grads = jax.value_and_grad(price_fn, argnums=tuple(range(9)))(
        kappa, theta, sigma, rho, v0, r, q, T, S0
    )
    names = ("d_kappa", "d_theta", "d_sigma", "d_rho", "d_v0", "d_r", "d_q", "d_T")
    out = {"price": price, "delta": grads[8]}
    out.update(dict(zip(names, grads[:8])))
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "american", "american_method", "n_spot", "n_vol", "n_time",
        "s_min_mult", "s_max_mult", "v_max",
    ),
)
def solve_batch(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american: bool = False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
) -> HestonPDEResult:
    """Price a whole BATCH of PDE problems in one compiled program.

    Every array argument broadcasts against the others along one leading
    batch axis — mixed strikes, maturities, rates, Heston parameters, spot
    levels, calls AND puts (``is_call`` is traced) all march together; only
    the grid sizes and the American mode are static.  The batch axis is
    embarrassingly parallel: shard it over the ``dp`` mesh axis
    (``jax.device_put`` with a ``NamedSharding(mesh, P("dp"))``) and XLA
    runs each shard's marches locally with zero communication — the PDE
    counterpart of the sharded calibration step (parallel/mesh.py).

    The reference prices one option per HestonPDESolver instance in a C++
    loop (heston_pde.hpp:56-150); this is the whole-desk replacement.
    """
    args = [jnp.atleast_1d(jnp.asarray(a)) for a in
            (kappa, theta, sigma, rho, v0, r, q, T, K)]
    is_call = jnp.atleast_1d(jnp.asarray(is_call))
    S0 = jnp.atleast_1d(jnp.asarray(S0))
    n = max(a.shape[0] for a in args + [is_call, S0])
    args = [jnp.broadcast_to(a, (n,)) for a in args]
    is_call = jnp.broadcast_to(is_call, (n,))
    S0 = jnp.broadcast_to(S0, (n,))

    core = functools.partial(
        _solve_core,
        american=american, american_method=american_method,
        n_spot=n_spot, n_vol=n_vol, n_time=n_time,
        s_min_mult=s_min_mult, s_max_mult=s_max_mult, v_max=v_max,
    )
    return jax.vmap(core)(*args, is_call, S0)


def _broadcast_batch(kappa, theta, sigma, rho, v0, r, q, T, K, is_call,
                     S0, american):
    args = [jnp.atleast_1d(jnp.asarray(a, dtype=jnp.float32)) for a in
            (kappa, theta, sigma, rho, v0, r, q, T, K)]
    is_call = jnp.atleast_1d(jnp.asarray(is_call)).astype(jnp.float32)
    american = jnp.atleast_1d(jnp.asarray(american)).astype(jnp.float32)
    S0 = jnp.atleast_1d(jnp.asarray(S0, dtype=jnp.float32))
    n = max(a.shape[0] for a in args + [is_call, S0, american])
    args = [jnp.broadcast_to(a, (n,)) for a in args]
    return (*args, jnp.broadcast_to(is_call, (n,)),
            jnp.broadcast_to(S0, (n,)), jnp.broadcast_to(american, (n,)), n)


@functools.partial(
    jax.jit,
    static_argnames=("use_it", "n_spot", "n_vol", "n_time", "s_min_mult",
                     "s_max_mult", "v_max", "interpret"),
)
def _fused_batch_impl(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, american,
    use_it, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max, interpret,
):
    from ..ops.adi_fused import adi_layout, fused_douglas_march_batched
    import math

    nS, nv, nT = n_spot, n_vol, n_time
    NSP, C, _ = adi_layout(nS, nv)
    B = kappa.shape[0]
    th = 0.5
    f32 = jnp.float32

    # K-scaled log-spot grid: x = ln(S/K) is SHARED across the batch, so dx
    # (and the S-operator lattice coefficients) are option-independent
    x = jnp.linspace(math.log(s_min_mult), math.log(s_max_mult), nS, dtype=f32)
    dx = (math.log(s_max_mult) - math.log(s_min_mult)) / (nS - 1)
    ex = jnp.exp(x)                                   # (nS,)
    v_grid = jnp.linspace(0.0, v_max, nv, dtype=f32)  # shared v grid
    dv = v_max / (nv - 1)
    dt = (T / nT).astype(f32)                         # (B,)

    sg = K[:, None] * ex[None, :]                     # (B, nS)
    pay = jnp.where(
        is_call[:, None] > 0.5,
        K[:, None] * jnp.maximum(ex - 1.0, 0.0)[None, :],
        K[:, None] * jnp.maximum(1.0 - ex, 0.0)[None, :],
    )

    # explicit/implicit S-operator interior rows by v level, (B, 3, nv)
    a = 0.5 * v_grid[None, :] / (dx * dx)             # (1, nv)
    bb = (r[:, None] - q[:, None] - 0.5 * v_grid[None, :]) / (2.0 * dx)
    a1 = jnp.stack([a - bb, -2.0 * a - 0.5 * r[:, None], a + bb], axis=1)
    i1 = jnp.stack([-th * dt[:, None] * a1[:, 0],
                    1.0 - th * dt[:, None] * a1[:, 1],
                    -th * dt[:, None] * a1[:, 2]], axis=1)

    # v-operator bands per option, row-aligned: L[j] multiplies V[:, j-1]
    a2lo, a2di, a2up = jax.vmap(
        _a2_diags, in_axes=(None, None, 0, 0, 0, 0)
    )(v_grid, dv, kappa, theta, sigma, r)             # (B, nv-1/nv/nv-1)
    zcol = jnp.zeros((B, 1), f32)
    a2L = jnp.concatenate([zcol, a2lo], axis=1)
    a2U = jnp.concatenate([a2up, zcol], axis=1)
    a2 = jnp.stack([a2L, a2di, a2U], axis=1)
    i2 = jnp.stack([-th * dt[:, None] * a2L,
                    1.0 - th * dt[:, None] * a2di,
                    -th * dt[:, None] * a2U], axis=1)

    mix = (rho * sigma / (4.0 * dx * dv))[:, None] * v_grid[None, :]
    mix = mix.at[:, nv - 1].set(0.0)                  # j = nv-1 is Dirichlet

    zb = jnp.zeros((B,), f32)
    sc = jnp.stack([dt, r, q, K, is_call, american, zb, zb], axis=1)

    def pad_to(arr, width):
        widths = [(0, 0)] * (arr.ndim - 1) + [(0, width - arr.shape[-1])]
        return jnp.pad(arr, widths)

    def bands(arr):                                   # (B, 3, nv) -> (B, 4, C)
        return pad_to(jnp.pad(arr, ((0, 0), (0, 1), (0, 0))), C)

    with jax.named_scope("heston_adi_fused_march"):
        Vt = fused_douglas_march_batched(
            pad_to(pay, NSP), pad_to(sg, NSP), bands(a1), bands(i1),
            bands(a2), bands(i2), pad_to(mix, C), sc,
            n_spot=nS, n_vol=nv, n_time=nT, use_it=use_it,
            interpret=interpret,
        )                                             # (B, nS, nv)

    # price + Greeks per option, on its own grid (same extraction as
    # _solve_core / the reference heston_pde.hpp:481-559)
    def extract(Vb, sgb, kb, tb, sb, rb, v0b, S0b, Tb, rhob, qb):
        price = grids.interp_bilinear(sgb, v_grid, Vb, S0b, v0b)
        i = jnp.clip(grids.find_index(sgb, S0b), 1, nS - 2)
        j = jnp.clip(grids.find_index(v_grid, v0b), 1, nv - 2)
        delta = (Vb[i + 1, j] - Vb[i - 1, j]) / (sgb[i + 1] - sgb[i - 1])
        davg = 0.5 * (sgb[i + 1] - sgb[i - 1])
        gamma = (Vb[i + 1, j] - 2.0 * Vb[i, j] + Vb[i - 1, j]) / (davg * davg)
        dV_dv = (Vb[i, j + 1] - Vb[i, j - 1]) / (2.0 * dv)
        vega = 2.0 * jnp.sqrt(v0b) * Tb * dV_dv
        # theta from the PDE: V_t = -(A0 + A1 + A2) V (same as _solve_core)
        lo_v, di_v, up_v = _a1_diags(v_grid, dx, rb, qb)
        a1l, a1d, a1u = _assemble_a1(nS, nv, lo_v, di_v, up_v)
        a2l, a2d, a2u = _a2_diags(v_grid, dv, kb, tb, sb, rb)
        theta_b = -(
            _apply_a0(Vb, v_grid, dx, dv, rhob, sb)
            + _apply_a1(Vb, a1l, a1d, a1u)
            + _apply_a2(Vb, a2l, a2d, a2u)
        )[i, j]
        return price, delta, gamma, vega, theta_b

    price, delta, gamma, vega, theta_g = jax.vmap(extract)(
        Vt, sg, kappa, theta, sigma, r, v0, S0, T, rho, q
    )
    return HestonPDEResult(price, delta, gamma, vega, theta_g, Vt,
                           sg, jnp.broadcast_to(v_grid, (B, nv)))


def solve_fused_batch(
    kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0,
    american=False,
    american_method: str = "projection",
    n_spot: int = 100,
    n_vol: int = 50,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    v_max: float = 1.0,
    interpret: bool = False,
) -> HestonPDEResult:
    """Batch PDE pricing through the fused march kernel, float32.

    Same broadcasting contract as :func:`solve_batch` — every array argument
    broadcasts along one leading batch axis, and ``is_call`` AND ``american``
    are per-option — but the whole march of each option runs inside one
    program of ONE Pallas (Triton) kernel
    (:func:`pde_tpu.ops.adi_fused.fused_douglas_march_batched`), one program
    per option.  ``american_method`` selects the projection or
    Ikonen-Toivanen treatment for the flagged options.

    Greeks: delta/gamma/vega/theta from the grid as in the reference
    (heston_pde.hpp:520-559) and :func:`solve_batch`; use :func:`greeks_ad`
    for exact adjoint sensitivities to the model parameters.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    if american_method not in ("projection", "it_lcp"):
        raise ValueError(
            "solve_fused_batch supports american_method 'projection' or "
            "'it_lcp'"
        )
    # the Ikonen-Toivanen buffer is a static kernel variant: decide it from
    # the caller's flags on the host, before they become device arrays
    use_it = american_method == "it_lcp" and bool(np_any_flag(american))
    (kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, american, _n) = \
        _broadcast_batch(kappa, theta, sigma, rho, v0, r, q, T, K, is_call,
                         S0, american)
    return _fused_batch_impl(
        kappa, theta, sigma, rho, v0, r, q, T, K, is_call, S0, american,
        use_it, n_spot, n_vol, n_time, s_min_mult, s_max_mult, v_max,
        interpret,
    )


def np_any_flag(arr) -> bool:
    """Host-side any() on a flag array, safe under tracing.

    The flag selects a CODE PATH, so it must resolve at trace time; when the
    array is a tracer (the batch pricer wrapped in an outer jit/vmap) the
    value is unknowable and the conservative answer is True — the masked
    update then handles per-element flags on device.
    """
    import numpy as np

    if isinstance(arr, jax.core.Tracer):
        return True
    return bool(np.any(np.asarray(arr) > 0.5))
