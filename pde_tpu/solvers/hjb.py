"""HJB optimal-stopping solver for mean-reversion trading.

Redesign of the reference HJBSolver (src/cpp/solvers/hjb_solver.hpp): solves

    max{ V_t + mu (theta - x) V_x + 0.5 sigma^2 V_xx - r V,  g(x) - V } = 0

by implicit Euler + per-step obstacle projection ``max(V, g)`` inside a
``lax.scan`` (the reference's time loop, hjb_solver.hpp:163-178).  The four
stopping problems (entry/exit, long/short) use the same exercise-value
heuristics as the reference (hjb_solver.hpp:258-314).  Boundary detection
(where V crosses the payoff) runs on the final value function.

All four problems of :func:`solve_all_boundaries` are solved in one vmapped
launch — the problem axis is just a batch axis over exercise-value vectors.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.tridiag import thomas_factor, thomas_solve_factored

__all__ = [
    "StoppingProblem",
    "HJBParams",
    "HJBResult",
    "OptimalTradingBoundaries",
    "solve",
    "solve_all_boundaries",
    "boundaries_batch",
    "extract_boundaries_batch",
]


class StoppingProblem(enum.IntEnum):
    ENTRY_LONG = 0
    ENTRY_SHORT = 1
    EXIT_LONG = 2
    EXIT_SHORT = 3


class HJBParams(NamedTuple):
    """Inputs (defaults match HJBParams, hjb_solver.hpp:61-65)."""

    theta: float = 0.0
    mu: float = 5.0
    sigma: float = 0.1
    r: float = 0.05
    c_entry: float = 0.001
    c_exit: float = 0.001
    T: float = 1.0
    problem: StoppingProblem = StoppingProblem.ENTRY_LONG
    n_space: int = 200
    n_time: int = 200
    x_min: float = -0.5
    x_max: float = 0.5
    # obstacle handling: "projection" = implicit-then-max (the reference's
    # splitting, hjb_solver.hpp:163-178); "psor" = rigorous free-boundary
    # LCP via red-black projected SOR (Leung-Li 2015 formulation);
    # "brennan_schwartz" = the SAME rigorous LCP solved EXACTLY in one
    # projected tridiagonal pass (valid here because every stopping region
    # is anchored at one grid end) — ~60x fewer serial ops than PSOR
    method: str = "projection"
    psor_iterations: int = 60
    # Replicate the reference matrix assembly exactly (hjb_solver.hpp:354-358
    # zeroes lower[0] and upper[n-2] AFTER the fill loop, so rows 1 and n-2
    # lose their implicit coupling to the extrapolated boundary rows).  On
    # this tight grid that shifts detected boundaries by up to one cell; used
    # by the golden parity tests (tests/golden/reference_pde_values.json).
    reference_compat: bool = False
    # Execution backend for SINGLE solves.  A lone 256-point march is a pure
    # serial dependency chain — CPU-shaped work — so "auto" routes it to the
    # native C++ twin (src/cpp/pde_solvers.cpp hjb_march/hjb_march_bs) when
    # the library is built, and falls back to the device march otherwise.
    # Books of pair configs should use :func:`boundaries_batch`, which stays
    # on the device where the batch amortizes the chain.  "device"/"native"
    # force a side; parity paths (reference_compat) always run on device.
    backend: str = "auto"


class HJBResult(NamedTuple):
    value_function: np.ndarray
    x_grid: np.ndarray
    lower_boundary: Optional[float]
    upper_boundary: Optional[float]
    stop_loss: Optional[float]

    def value_at(self, x: float) -> float:
        return float(np.interp(x, self.x_grid, self.value_function))

    def should_stop(self, x: float) -> bool:
        if self.lower_boundary is not None and x <= self.lower_boundary:
            return True
        if self.upper_boundary is not None and x >= self.upper_boundary:
            return True
        return False


class OptimalTradingBoundaries(NamedTuple):
    entry_long: float
    entry_short: float
    exit_long: float
    exit_short: float
    stop_loss_long: float
    stop_loss_short: float


def _exercise_value(x, p: HJBParams, problem: StoppingProblem, xp=jnp):
    """Stopping payoff g(x) per problem (hjb_solver.hpp:258-314).

    Entry payoffs discount the theta-reversion profit by the heuristic
    expected hitting time log(|x - theta| / sigma) / mu (floored at 0).
    ``xp`` selects the array namespace: ``jnp`` on the device path, ``np``
    on the native host path (a lone eager jnp op costs a device
    round-trip, so the host path must never touch the device).
    """
    dev = xp.abs(x - p.theta)
    safe = xp.maximum(dev / p.sigma, 1e-300)
    t_hit = xp.maximum(xp.log(safe) / p.mu, 0.0)
    disc = xp.exp(-p.r * t_hit)

    profit_long = xp.where(x >= p.theta, 0.0, (p.theta - x) * disc)
    profit_short = xp.where(x <= p.theta, 0.0, (x - p.theta) * disc)

    if problem == StoppingProblem.ENTRY_LONG:
        return profit_long - p.c_entry
    if problem == StoppingProblem.ENTRY_SHORT:
        return profit_short - p.c_entry
    if problem == StoppingProblem.EXIT_LONG:
        return x - p.c_exit
    return -x - p.c_exit


@functools.partial(jax.jit, static_argnames=(
    "n_space", "n_time", "method", "psor_iterations", "reference_compat"))
def _march(exercise, theta, mu, sigma, r, T, x_min, x_max, n_space, n_time,
           method="projection", psor_iterations=60, reference_compat=False,
           bs_reverse=False):
    """Implicit time march with obstacle projection; batched over a leading
    problems axis of ``exercise``.  (hjb_solver.hpp:150-190)."""
    x = jnp.linspace(x_min, x_max, n_space)
    dx = (x_max - x_min) / (n_space - 1)
    dt = T / n_time

    # OU generator.  Projection mode: central differences, matching the
    # reference (hjb_solver.hpp:321-361).  PSOR mode: monotone upwind
    # differencing — projected SOR requires the M-matrix property, which
    # central advection violates once |drift| dx > sigma^2.
    diff = 0.5 * sigma * sigma
    a = diff / (dx * dx)
    drift = mu * (theta - x[1:-1])
    if method in ("psor", "brennan_schwartz"):
        L_m = a + jnp.maximum(-drift, 0.0) / dx
        L_p = a + jnp.maximum(drift, 0.0) / dx
        L_c = -2.0 * a - jnp.abs(drift) / dx - r
    else:
        b = drift / (2.0 * dx)
        L_m = a - b
        L_c = -2.0 * a - r
        L_p = a + b

    n = n_space
    idx = jnp.arange(n)
    interior = (idx > 0) & (idx < n - 1)
    diag = jnp.where(interior, 0.0, 1.0).at[1:-1].add(1.0 - dt * L_c)
    lower = jnp.zeros(n - 1).at[:-1].set(-dt * L_m)
    upper = jnp.zeros(n - 1).at[1:].set(-dt * L_p)
    # boundary coupling rows are identity (hjb_solver.hpp:354-358)
    lower = lower.at[-1].set(0.0)
    upper = upper.at[0].set(0.0)
    if reference_compat:
        # the reference additionally zeroes A[1,0] and A[n-2,n-1]
        # (lower[0] / upper[n-2] in its band layout)
        lower = lower.at[0].set(0.0)
        upper = upper.at[-1].set(0.0)

    exercise = jnp.asarray(exercise)

    # the operator is time-independent: factorize once, outside the scan —
    # the per-step serial chains are then multiply/fma-only
    if method == "brennan_schwartz":
        from .lcp import brennan_schwartz_apply, brennan_schwartz_factor

        bs_factors = brennan_schwartz_factor(lower, diag, upper, bs_reverse)
    elif method != "psor":
        th_factors = thomas_factor(lower, diag, upper)

    def step(V, _):
        if method == "psor":
            from .lcp import projected_sor

            V, _resid = projected_sor(
                lower, diag, upper, V, exercise, x0=V, n_iter=psor_iterations
            )
        elif method == "brennan_schwartz":
            V = brennan_schwartz_apply(bs_factors, V, exercise)
        else:
            V = thomas_solve_factored(th_factors, V)
            V = jnp.maximum(V, exercise)
        # linear extrapolation boundaries (hjb_solver.hpp:363-368)
        V = V.at[..., 0].set(2.0 * V[..., 1] - V[..., 2])
        V = V.at[..., -1].set(2.0 * V[..., -2] - V[..., -3])
        return V, None

    V, _ = jax.lax.scan(step, exercise, None, length=n_time)
    return x, V


# Brennan-Schwartz sweep direction per stopping problem: the contact
# (stopping) region is anchored at the LEFT grid end (False) or RIGHT (True).
_BS_REVERSE = {
    StoppingProblem.ENTRY_LONG: False,   # enter long when x is low
    StoppingProblem.ENTRY_SHORT: True,   # enter short when x is high
    StoppingProblem.EXIT_LONG: True,     # exit long when x has risen
    StoppingProblem.EXIT_SHORT: False,   # exit short when x has fallen
}


def _find_boundaries(V: np.ndarray, x: np.ndarray, g: np.ndarray):
    """Continuation/stopping crossings of V - g (hjb_solver.hpp:375-403).

    Vectorized over the grid; like the reference's scan, the LAST crossing of
    each kind wins when there are several.
    """
    diff = V - g
    prev, curr = diff[:-1], diff[1:]
    dx_seg = x[1:] - x[:-1]

    lower_bd = upper_bd = None
    down = np.nonzero((prev > 1e-10) & (curr <= 1e-10))[0]
    if down.size:
        i = down[-1]
        t = prev[i] / (prev[i] - curr[i])
        lower_bd = float(x[i] + t * dx_seg[i])
    up = np.nonzero((prev <= 1e-10) & (curr > 1e-10))[0]
    if up.size:
        i = up[-1]
        t = -prev[i] / (curr[i] - prev[i])
        upper_bd = float(x[i] + t * dx_seg[i])
    return lower_bd, upper_bd


def _native_march(params: HJBParams, g_np: np.ndarray, problem) -> Optional[np.ndarray]:
    """Route one march to the C++ host twin; None if unavailable/ineligible."""
    if params.reference_compat or params.backend == "device":
        return None
    if params.method not in ("projection", "brennan_schwartz"):
        return None
    try:
        from .. import native

        if not native.is_available():
            raise RuntimeError
    except Exception:
        if params.backend == "native":
            raise
        return None
    args = (float(params.theta), float(params.mu), float(params.sigma),
            float(params.r), float(params.T), float(params.x_min),
            float(params.x_max), g_np)
    if params.method == "projection":
        return native.hjb_march(*args, n_time=params.n_time)
    return native.hjb_march_bs(*args, bool(_BS_REVERSE[problem]),
                               n_time=params.n_time)


def _native_march_all(params: HJBParams, g_np_all: np.ndarray):
    """All four marches on the host twin; None if ineligible/unavailable.

    Brennan-Schwartz runs the four problems concurrently in one call
    (hjb_march_bs_multi, one std::thread per march); projection mode loops
    the single-march oracle.
    """
    if params.reference_compat or params.backend == "device":
        return None
    if params.method not in ("projection", "brennan_schwartz"):
        return None
    try:
        from .. import native

        if not native.is_available():
            raise RuntimeError
    except Exception:
        if params.backend == "native":
            raise
        return None
    args = (float(params.theta), float(params.mu), float(params.sigma),
            float(params.r), float(params.T), float(params.x_min),
            float(params.x_max))
    if params.method == "brennan_schwartz":
        rev = [_BS_REVERSE[pr] for pr in StoppingProblem]
        return native.hjb_march_bs_multi(*args, g_np_all, rev,
                                         n_time=params.n_time)
    return np.stack([native.hjb_march(*args, g_np_all[pr], n_time=params.n_time)
                     for pr in StoppingProblem])


def _host_grid_and_payoffs(params: HJBParams, problems) -> tuple:
    """x grid + stacked exercise vectors, pure numpy (no device traffic)."""
    x_np = np.linspace(float(params.x_min), float(params.x_max),
                       params.n_space, dtype=np.float64)
    g_np = np.stack([np.asarray(_exercise_value(x_np, params, pr, xp=np),
                                np.float64) for pr in problems])
    return x_np, g_np


def solve(params: HJBParams) -> HJBResult:
    """Solve one stopping problem; boundaries extracted host-side."""
    if params.mu <= 0 or params.sigma <= 0:
        raise ValueError("mu and sigma must be positive")
    if params.r < 0 or params.T <= 0:
        raise ValueError("r must be >= 0 and T > 0")
    if params.n_space < 10:
        raise ValueError("n_space must be >= 10")

    # payoff + grid assembled host-side: the native route then never touches
    # the device, and the device route uploads g once into one jitted march
    x_np, g_np = _host_grid_and_payoffs(params, [params.problem])
    g_np = g_np[0]

    native_V = _native_march(params, g_np, params.problem)
    if native_V is not None:
        lo, hi = _find_boundaries(native_V, x_np, g_np)
        return HJBResult(native_V, x_np, lo, hi, None)
    _, V = _march(
        g_np, params.theta, params.mu, params.sigma, params.r, params.T,
        params.x_min, params.x_max, params.n_space, params.n_time,
        method=params.method, psor_iterations=params.psor_iterations,
        reference_compat=bool(params.reference_compat),
        bs_reverse=np.asarray(_BS_REVERSE[params.problem]),
    )
    V_np = np.asarray(jax.device_get(V))
    lo, hi = _find_boundaries(V_np, x_np, g_np)
    return HJBResult(V_np, x_np, lo, hi, None)


def solve_all_boundaries(params: HJBParams) -> OptimalTradingBoundaries:
    """All four stopping problems in ONE batched march (hjb_solver.hpp:199-234).

    The reference runs four sequential solves; here the four exercise vectors
    stack on a batch axis and the implicit solver broadcasts over it.
    Fallback defaults and the 2-sigma stop-loss heuristics match the
    reference exactly.
    """
    x_np, g_np_all = _host_grid_and_payoffs(params, list(StoppingProblem))

    V_np = _native_march_all(params, g_np_all)
    if V_np is not None:
        return _assemble_boundaries(params, x_np, V_np, g_np_all)

    _, V_all = _march(
        g_np_all, params.theta, params.mu, params.sigma, params.r, params.T,
        params.x_min, params.x_max, params.n_space, params.n_time,
        method=params.method, psor_iterations=params.psor_iterations,
        reference_compat=bool(params.reference_compat),
        bs_reverse=np.asarray([_BS_REVERSE[pr] for pr in StoppingProblem]),
    )
    V_np = np.asarray(jax.device_get(V_all))
    return _assemble_boundaries(params, x_np, V_np, g_np_all)


def _assemble_boundaries(params: HJBParams, x_np, V_np, g_np):
    """Boundary detection + reference fallback/stop-loss semantics
    (hjb_solver.hpp:205-232) from the four final value functions."""
    sigma_stat = params.sigma / np.sqrt(2.0 * params.mu)

    bounds = {}
    for pr in StoppingProblem:
        lo, hi = _find_boundaries(V_np[pr], x_np, g_np[pr])
        bounds[pr] = (lo, hi)

    entry_long = bounds[StoppingProblem.ENTRY_LONG][0]
    if entry_long is None:
        entry_long = params.theta - 2.0 * sigma_stat
    entry_short = bounds[StoppingProblem.ENTRY_SHORT][1]
    if entry_short is None:
        entry_short = params.theta + 2.0 * sigma_stat
    exit_long = bounds[StoppingProblem.EXIT_LONG][1]
    if exit_long is None:
        exit_long = params.theta
    exit_short = bounds[StoppingProblem.EXIT_SHORT][0]
    if exit_short is None:
        exit_short = params.theta

    return OptimalTradingBoundaries(
        entry_long=entry_long,
        entry_short=entry_short,
        exit_long=exit_long,
        exit_short=exit_short,
        stop_loss_long=entry_long - 2.0 * sigma_stat,
        stop_loss_short=entry_short + 2.0 * sigma_stat,
    )


@functools.partial(jax.jit, static_argnames=("n_space", "n_time", "method"))
def boundaries_batch(theta, mu, sigma, r, c_entry, c_exit, T,
                     n_space=200, n_time=200, x_min=None, x_max=None,
                     method="brennan_schwartz"):
    """All four stopping problems for a BOOK of pair configs in ONE launch.

    The reference computes boundaries per pair with four sequential C++
    solves (hjb_solver.hpp:199-234); here ``(theta, mu, sigma)`` are (B,)
    vectors, the (B, 4) problem/config plane is one batch axis, and the
    implicit marches broadcast over it — the serial time chain amortizes
    across the whole book.  Per-config grids default to
    theta +- 15.8 sigma/sqrt(2 mu) (the single-config default's span).

    Returns device arrays ``(x_grids (B, n), V (B, 4, n), g (B, 4, n))``;
    feed to :func:`extract_boundaries_batch` for host-side boundary lists.
    """
    theta, mu, sigma = map(jnp.asarray, (theta, mu, sigma))
    sigma_stat = sigma / jnp.sqrt(2.0 * mu)
    if x_min is None:
        x_min = theta - 15.8 * sigma_stat
    if x_max is None:
        x_max = theta + 15.8 * sigma_stat
    rev = jnp.asarray([_BS_REVERSE[pr] for pr in StoppingProblem])

    def one(th, m, s, xmin, xmax):
        pp = HJBParams(theta=th, mu=m, sigma=s, r=r, c_entry=c_entry,
                       c_exit=c_exit, T=T, n_space=n_space, n_time=n_time)
        x = jnp.linspace(xmin, xmax, n_space)
        g_all = jnp.stack([_exercise_value(x, pp, pr) for pr in StoppingProblem])
        _, V = _march(g_all, th, m, s, r, T, xmin, xmax, n_space, n_time,
                      method=method, bs_reverse=rev)
        return x, V, g_all

    return jax.vmap(one)(theta, mu, sigma,
                         jnp.broadcast_to(x_min, theta.shape),
                         jnp.broadcast_to(x_max, theta.shape))


def extract_boundaries_batch(x_grids, V, g, mu, sigma, theta):
    """Host-side boundary extraction for :func:`boundaries_batch` output."""
    x_np, V_np, g_np = jax.device_get((x_grids, V, g))
    mu = np.asarray(mu); sigma = np.asarray(sigma); theta = np.asarray(theta)
    out = []
    for b in range(V_np.shape[0]):
        sigma_stat = sigma[b] / np.sqrt(2.0 * mu[b])
        bd = {}
        for pr in StoppingProblem:
            bd[pr] = _find_boundaries(V_np[b, pr], x_np[b], g_np[b, pr])
        el = bd[StoppingProblem.ENTRY_LONG][0]
        el = theta[b] - 2.0 * sigma_stat if el is None else el
        es = bd[StoppingProblem.ENTRY_SHORT][1]
        es = theta[b] + 2.0 * sigma_stat if es is None else es
        xl = bd[StoppingProblem.EXIT_LONG][1]
        xl = theta[b] if xl is None else xl
        xs = bd[StoppingProblem.EXIT_SHORT][0]
        xs = theta[b] if xs is None else xs
        out.append(OptimalTradingBoundaries(
            entry_long=el, entry_short=es, exit_long=xl, exit_short=xs,
            stop_loss_long=el - 2.0 * sigma_stat,
            stop_loss_short=es + 2.0 * sigma_stat,
        ))
    return out
