"""Black-Scholes 1D PDE solver (log-space Crank-Nicolson).

Redesign of the reference BlackScholesPDESolver
(src/cpp/solvers/black_scholes_pde.hpp): same discretization — log-space grid
S in [K*s_min_mult, K*s_max_mult], central differences, Crank-Nicolson /
implicit schemes, Dirichlet boundaries with discounting (over time-to-expiry;
the reference discounts over calendar time, black_scholes_pde.hpp:127, a
non-converging deep-ITM boundary error corrected here), per-step
``max(V, payoff)`` projection for American exercise — but the backward time
march is a ``lax.scan`` whose per-step work is one batched tridiagonal solve,
so ``vmap`` over strikes/vols/expiries prices whole books per launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import grids
from ..ops.tridiag import thomas_factor, thomas_solve_factored

__all__ = ["BSPDEParams", "BSPDEResult", "solve", "solve_fused_batch"]


class BSPDEParams(NamedTuple):
    """Solver inputs (defaults match BlackScholesPDEParams, black_scholes_pde.hpp:58-62)."""

    sigma: float = 0.2
    r: float = 0.05
    q: float = 0.0
    T: float = 1.0
    K: float = 100.0
    is_call: bool = True
    american: bool = False
    n_space: int = 200
    n_time: int = 100
    s_min_mult: float = 0.2
    s_max_mult: float = 5.0
    scheme: str = "crank_nicolson"  # "crank_nicolson" | "implicit" | "explicit"
    # American exercise handling: "projection" = implicit-solve-then-max
    # (the reference's splitting, black_scholes_pde.hpp:116-124); "psor" =
    # the rigorous LCP via red-black projected SOR (solvers/lcp.py);
    # "brennan_schwartz" = the SAME LCP solved EXACTLY in one projected
    # tridiagonal pass (the 1D American exercise region is one-sided:
    # puts contact at low S, calls at high S)
    american_method: str = "projection"
    psor_iterations: int = 60
    # Reproduce the reference solver bit-for-bit (black_scholes_pde.hpp:116-147):
    # boundary discount over CALENDAR time (its non-converging defect — see
    # apply_bc), no dividend discount on the S-leg, and the reference's
    # solve -> American-max -> BC step ordering.  For parity testing against
    # tests/golden/reference_pde_values.json only; leave False for pricing.
    reference_compat: bool = False


class BSPDEResult(NamedTuple):
    price: jnp.ndarray
    delta: jnp.ndarray
    gamma: jnp.ndarray
    theta: jnp.ndarray
    prices: jnp.ndarray  # value on the grid at t=0
    spot_grid: jnp.ndarray
    early_exercise_optimal: jnp.ndarray


def _operator_coeffs(p: BSPDEParams, dx):
    """Interior-point operator L = diffusion + advection - r I in log space.

    PDE in x = log S: V_t + 0.5 sigma^2 V_xx + (r - q - sigma^2/2) V_x - r V = 0
    (black_scholes_pde.hpp:185-206).
    """
    sigma2 = p.sigma * p.sigma
    drift = p.r - p.q - 0.5 * sigma2
    a = 0.5 * sigma2 / (dx * dx)
    b = drift / (2.0 * dx)
    L_m = a - b
    L_c = -2.0 * a - p.r
    L_p = a + b
    return L_m, L_c, L_p


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_space", "n_time", "is_call", "american", "scheme", "american_method",
        "psor_iterations", "reference_compat",
    ),
)
def _solve_impl(
    S0, sigma, r, q, T, K, s_min_mult, s_max_mult, n_space, n_time, is_call, american, scheme,
    american_method="projection", psor_iterations=60, reference_compat=False,
):
    p = BSPDEParams(
        sigma=sigma, r=r, q=q, T=T, K=K, is_call=is_call, american=american,
        n_space=n_space, n_time=n_time, s_min_mult=s_min_mult, s_max_mult=s_max_mult,
        scheme=scheme,
    )
    s_grid = jnp.exp(
        jnp.linspace(jnp.log(K * s_min_mult), jnp.log(K * s_max_mult), n_space)
    )
    dx = jnp.log(s_grid[-1] / s_grid[0]) / (n_space - 1)
    dt = T / n_time

    payoff = jnp.where(is_call, jnp.maximum(s_grid - K, 0.0), jnp.maximum(K - s_grid, 0.0))

    L_m, L_c, L_p = _operator_coeffs(p, dx)

    # implicit system diagonals (boundary rows are identity rows)
    interior = jnp.arange(n_space)
    is_interior = (interior > 0) & (interior < n_space - 1)
    # theta-scheme weight on the implicit side (TimeScheme semantics,
    # pde_core.hpp:186): CN = 1/2, implicit Euler = 1, explicit Euler = 0
    # (explicit needs dt under the CFL bound, pde_core.hpp:292-309)
    w = {"crank_nicolson": 0.5, "implicit": 1.0, "explicit": 0.0}[scheme]

    diag = jnp.where(is_interior, 1.0 - w * dt * L_c, 1.0)
    lower = jnp.where(is_interior[1:], -w * dt * L_m, 0.0)
    upper = jnp.where(is_interior[:-1], -w * dt * L_p, 0.0)
    if reference_compat:
        # the reference zeroes A[1,0] and A[n-2,n-1] after assembly
        # (black_scholes_pde.hpp:250-254 guards + the post-loop zeroing), so
        # rows 1 and n-2 lose their implicit coupling to the Dirichlet rows
        lower = lower.at[0].set(0.0)
        upper = upper.at[-1].set(0.0)

    def explicit_rhs(V):
        """(I + (1-w) dt L) V on interior points."""
        if w == 1.0:
            return V
        LV = L_m * V[:-2] + L_c * V[1:-1] + L_p * V[2:]
        return V.at[1:-1].add((1.0 - w) * dt * LV)

    def apply_bc(V, tau):
        """Dirichlet values at time-to-expiry ``tau``.

        DEVIATION from the reference: black_scholes_pde.hpp:127 passes
        calendar time (n_time-step-1)*dt to the discount instead of the
        time since expiry, so its boundary value at t=0 is the UNdiscounted
        K - S_min — a non-converging O(K(1-e^{-rT})) error in the deep
        ITM/OTM wings (~0.16 on the canonical put).  Discount over tau, and
        carry the dividend discount on the S leg (In 't Hout-Foulon
        convention, as in solvers/heston_adi.py).

        ``reference_compat`` reinstates the reference behaviour exactly —
        discount over calendar time T - tau and no dividend discount on the
        S-leg — so the golden fixtures in
        tests/golden/reference_pde_values.json reproduce to solver
        round-off."""
        if reference_compat:
            df_r = jnp.exp(-r * (T - tau))
            df_q = jnp.ones_like(df_r)
        else:
            df_r = jnp.exp(-r * tau)
            df_q = jnp.exp(-q * tau)
        if is_call:
            V = V.at[0].set(0.0)
            V = V.at[-1].set(s_grid[-1] * df_q - K * df_r)
        else:
            V = V.at[0].set(K * df_r - s_grid[0] * df_q)
            V = V.at[-1].set(0.0)
        return V

    # time-independent operator: factorize once outside the scan so the
    # per-step serial chains avoid division latency
    if american and american_method == "brennan_schwartz":
        from .lcp import brennan_schwartz_apply, brennan_schwartz_factor

        # put: exercise region at low S (sweep from the left);
        # call (q > 0): at high S
        bs_factors = brennan_schwartz_factor(lower, diag, upper,
                                             reverse=bool(is_call))
    elif not (american and american_method == "psor"):
        th_factors = thomas_factor(lower, diag, upper)

    def step(V, tau):
        rhs = explicit_rhs(V)
        if american and american_method == "psor":
            from .lcp import projected_sor

            V, _ = projected_sor(
                lower, diag, upper, rhs, payoff, x0=V, n_iter=psor_iterations
            )
        elif american and american_method == "brennan_schwartz":
            V = brennan_schwartz_apply(bs_factors, rhs, payoff)
        else:
            V = thomas_solve_factored(th_factors, rhs)
        if reference_compat:
            # reference step ordering (black_scholes_pde.hpp:117-127):
            # American projection first, Dirichlet overwrite last (unfloored)
            if american:
                V = jnp.maximum(V, payoff)
            V = apply_bc(V, tau)
        else:
            V = apply_bc(V, tau)
            if american:
                # after the Dirichlet overwrite so the boundary rows are
                # floored at intrinsic too (an American value can never sit
                # below payoff)
                V = jnp.maximum(V, payoff)
        return V, None

    # backward march; after step k the grid sits at time-to-expiry k*dt
    taus = (T / n_time) * jnp.arange(1, n_time + 1, dtype=s_grid.dtype)
    V, _ = jax.lax.scan(step, payoff, taus)

    if reference_compat:
        # Reference readout defect (pde_core.hpp:101-133): find_index returns
        # the NEAREST grid point and interpolate always uses the segment
        # [i-1, i] — when the nearest point lies left of S0 this EXTRAPOLATES
        # from the wrong segment (t > 1), biasing convex payoffs low by
        # O(gamma * dS^2) at every off-grid spot.  interp_linear (the default
        # path) brackets correctly.
        i_lo = jnp.searchsorted(s_grid, S0, side="right") - 1
        i_lo = jnp.clip(i_lo, 0, n_space - 2)
        nearest = jnp.where(
            S0 - s_grid[i_lo] < s_grid[i_lo + 1] - S0, i_lo, i_lo + 1
        )
        i = jnp.clip(nearest, 1, n_space - 2)
        t = (S0 - s_grid[i - 1]) / (s_grid[i] - s_grid[i - 1])
        price = (1.0 - t) * V[i - 1] + t * V[i]
    else:
        price = None  # _readout_1d brackets correctly

    price, delta, gamma, theta, early_ex = _readout_1d(
        V, s_grid, S0, K, sigma, r, q, T, is_call, american, price=price
    )
    return BSPDEResult(price, delta, gamma, theta, V, s_grid, early_ex)


def _readout_1d(V, s_grid, S0, K, sigma, r, q, T, is_call, american,
                price=None):
    """Shared readout: price + grid Greeks + analytic theta + early-exercise
    flag from a terminal 1D value grid.

    Single source for :func:`solve` (_solve_impl), :func:`solve_fused_batch`
    (per lane, under vmap) and ``parallel.adi_sharded.sharded_bs_solve``.
    ``V``/``s_grid`` are 1D (n,); pass a precomputed ``price`` to override
    the bracketing interpolation (the reference_compat readout).
    """
    n = s_grid.shape[0]
    call_q = jnp.asarray(is_call, bool)
    amer_q = jnp.asarray(american, bool)
    if price is None:
        price = grids.interp_linear(s_grid, V, S0)

    # Greeks from the grid (black_scholes_pde.hpp:292-312)
    i = jnp.clip(grids.find_index(s_grid, S0), 1, n - 2)
    delta = (V[i + 1] - V[i - 1]) / (s_grid[i + 1] - s_grid[i - 1])
    davg = 0.5 * (s_grid[i + 1] - s_grid[i - 1])
    gamma = (V[i + 1] - 2.0 * V[i] + V[i - 1]) / (davg * davg)

    # analytic BS theta at S0 (black_scholes_pde.hpp:314-331)
    d1 = (jnp.log(S0 / K) + (r - q + 0.5 * sigma * sigma) * T) / (sigma * jnp.sqrt(T))
    nd1 = jnp.exp(-0.5 * d1 * d1) / jnp.sqrt(2.0 * jnp.pi)
    theta = -S0 * nd1 * sigma / (2.0 * jnp.sqrt(T))
    theta = theta + jnp.where(call_q, -1.0, 1.0) * r * K * jnp.exp(-r * T) * 0.5

    payoff_s0 = jnp.where(call_q, jnp.maximum(S0 - K, 0.0), jnp.maximum(K - S0, 0.0))
    early_ex = amer_q & (price > payoff_s0 + 1e-10)
    return price, delta, gamma, theta, early_ex


def solve(params: BSPDEParams, S0) -> BSPDEResult:
    """Solve the BS PDE and return price/Greeks at ``S0``.

    jit-compiled with static grid sizes; ``vmap`` over S0/sigma/K to price in
    batches (the batched replacement for looping solver objects).
    """
    if params.sigma <= 0:
        raise ValueError("sigma must be positive")
    if params.T <= 0:
        raise ValueError("T must be positive")
    if params.K <= 0:
        raise ValueError("K must be positive")
    if params.n_space < 10 or params.n_time < 10:
        raise ValueError("n_space and n_time must be >= 10")
    if params.scheme not in ("crank_nicolson", "implicit", "explicit"):
        raise ValueError(f"unknown scheme {params.scheme!r}")
    return _solve_impl(
        S0,
        params.sigma,
        params.r,
        params.q,
        params.T,
        params.K,
        params.s_min_mult,
        params.s_max_mult,
        params.n_space,
        params.n_time,
        bool(params.is_call),
        bool(params.american),
        params.scheme,
        params.american_method,
        params.psor_iterations,
        bool(params.reference_compat),
    )


@functools.partial(
    jax.jit,
    static_argnames=("n_space", "n_time", "scheme", "interpret"),
)
def solve_fused_batch(
    sigma, r, q, T, K, is_call, S0,
    american=False,
    n_space: int = 200,
    n_time: int = 100,
    s_min_mult: float = 0.2,
    s_max_mult: float = 5.0,
    scheme: str = "crank_nicolson",
    interpret: bool = False,
) -> BSPDEResult:
    """Price a whole option BOOK through ONE fused march kernel, float32.

    Every array argument broadcasts along one leading batch axis;
    ``is_call`` and ``american`` are per-option, so a batch may mix strikes,
    maturities, rates, vols, calls with puts, and European with American
    (projection mode).  The constant-coefficient march is the special case
    of the local-vol kernel
    (:func:`pde_tpu.ops.cn1d_tv_fused.fused_cn_march_1d_tv`) whose operator
    rows do not change with the time level.  The reference prices such
    books by looping one C++ solve per option (black_scholes_pde.hpp:97-147).

    Greeks from the grid + analytic theta, exactly as :func:`solve`.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    from ..ops.cn1d_tv_fused import fused_cn_march_1d_tv

    if scheme not in ("crank_nicolson", "implicit"):
        raise ValueError(
            f"unknown or unsupported scheme {scheme!r}: the fused march "
            "is implicit-path only ('crank_nicolson' or 'implicit'); use "
            "solve() for 'explicit'"
        )
    if n_space < 10 or n_time < 10:
        raise ValueError("n_space and n_time must be >= 10")

    f32 = jnp.float32
    sigma, r, q, T, K, S0 = (jnp.atleast_1d(jnp.asarray(a, f32))
                             for a in (sigma, r, q, T, K, S0))
    call_f = jnp.atleast_1d(jnp.asarray(is_call)).astype(f32)
    amer_f = jnp.atleast_1d(jnp.asarray(american)).astype(f32)
    B = max(a.shape[0] for a in (sigma, r, q, T, K, S0, call_f, amer_f))
    sigma, r, q, T, K, S0, call_f, amer_f = (
        jnp.broadcast_to(a, (B,))
        for a in (sigma, r, q, T, K, S0, call_f, amer_f))

    # K-scaled log grid: s_i = K * g_i with g_i = s_min_mult * e^{i dx};
    # dx is the SAME for every option
    n = n_space
    dx = jnp.log(s_max_mult / s_min_mult) / (n - 1)
    g_base = s_min_mult * jnp.exp(dx * jnp.arange(n, dtype=f32))   # (n,)
    s_grid = K[None, :] * g_base[:, None]                           # (n, B)
    pay = jnp.where(call_f[None, :] > 0.5,
                    jnp.maximum(s_grid - K[None, :], 0.0),
                    jnp.maximum(K[None, :] - s_grid, 0.0))

    # constant operator rows, repeated over the time levels
    sigma2 = sigma * sigma
    a = 0.5 * sigma2 / (dx * dx)
    b = (r - q - 0.5 * sigma2) / (2.0 * dx)
    rows = jnp.concatenate([jnp.broadcast_to(c, (n, B)) for c in
                            (a - b, -2.0 * a - r, a + b)])          # (3n, B)
    bands = jnp.broadcast_to(rows, (n_time + 1, 3 * n, B))
    sc = jnp.stack([T / n_time, r, q, K, call_f, amer_f,
                    K * s_min_mult, K * s_max_mult])                # (8, B)
    w = {"crank_nicolson": 0.5, "implicit": 1.0}[scheme]
    with jax.named_scope("bs_fused_march"):
        V = fused_cn_march_1d_tv(pay, bands, sc, n_space=n, n_time=n_time,
                                 w=w, interpret=interpret)          # (n, B)

    # per-option readout (price + grid Greeks + analytic theta), vectorized
    price, delta, gamma, theta, early = jax.vmap(
        lambda Vb, sgb, S0b, Kb, sigb, rb, qb, Tb, callb, amerb:
            _readout_1d(Vb, sgb, S0b, Kb, sigb, rb, qb, Tb,
                        callb > 0.5, amerb > 0.5)
    )(V.T, s_grid.T, S0, K, sigma, r, q, T, call_f, amer_f)
    return BSPDEResult(price, delta, gamma, theta, V.T, s_grid.T, early)
