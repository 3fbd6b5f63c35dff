"""Rough Heston Monte Carlo via the Markovian multifactor lift.

Path simulation for the rough Heston model (models/rough_heston.py gives
the CF/pricing side).  The variance process carries a fractional kernel
K(t) = t^{alpha-1}/Gamma(alpha), so it is non-Markovian — direct simulation
needs an O(N^2) Volterra convolution per path.  The **multifactor lift**
(Abi Jaber & El Euch 2019, "Lifting the Heston model"; Abi Jaber 2019)
approximates the kernel by a sum of exponentials,

    K(t) ~= sum_j c_j exp(-x_j t),

obtained from the kernel's inverse-Laplace representation
K(t) = (Gamma(alpha) Gamma(1-alpha))^{-1} int x^{-alpha} e^{-xt} dx on a
geometric node grid.  Each exponential factor is then an OU-type state

    dY_j = -x_j Y_j dt + dF_t,   V_t = v0 + sum_j c_j Y_j(t),
    dF_t = lam (theta - V_t) dt + nu sqrt(V_t^+) dW_t,

i.e. an (n_paths, n_factors) Markovian system — one fused elementwise
update per time step inside ``lax.scan``, the same device shape as the
classic QE engine (models/heston_mc.py).  The factor recursion uses the
exact exponential decay e^{-x_j dt} with the integrated-kernel average
gamma_j = (1 - e^{-x_j dt})/(x_j dt) on the shared increment, so stiff
fast factors (x_j ~ 1e4) stay stable at any step size.

Validation: European prices cross-check the fractional-Riccati CF pricer
(price_rough) — two fully independent numerical routes to the same model.
The reference platform has neither (its models stop at classic Heston,
src/cpp/models/heston.cpp).

Accuracy caveat (measured, tests pin it): at H = 1/2 the engine matches
the CF to MC noise (~0.3%/0.6% ATM/wing at 65k paths), but the weak
convergence rate of ANY Euler-family scheme degrades toward O(dt^H) as the
kernel roughens — at H = 0.1, T = 0.25 the far-OTM wing carries a ~3-5%
relative bias that refining steps/factors moves only slowly (kernel-fit
error is <2e-4, time-grid and node-count refinements were tried and
plateau).  Use the CF pricer for Europeans; this engine is for
path-dependent and AMERICAN payoffs, where no CF/grid route exists and the
bias is diluted by the dominant near-the-money mass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import result_dtype
from .heston_mc import MCPaths, _mc_estimate
from .rough_heston import RoughHestonParams, _gamma

__all__ = [
    "lift_nodes",
    "simulate_lifted",
    "simulate_lifted_paths",
    "price_european_rough_mc",
    "price_american_rough_lsm",
]


def lift_nodes(hurst, n_factors: int = 20,
               x_min: float = 1e-3, x_max: float = 3e4,
               dtype=jnp.float64):
    """Exponential-sum approximation of the fractional kernel.

    Nodes x_j log-uniform on [x_min, x_max] (from the kernel's
    inverse-Laplace representation); weights by relative least squares on a
    log time-grid (see body).  The node GRID is static (so traced
    maturities never force recompiles); the default [1e-3, 3e4] spans ~7
    decades — slow enough for multi-year horizons, fast enough for the
    sub-millisecond transients a 256-step daily-scale simulation resolves.
    Only the weights c depend on the (possibly traced) hurst.  Returns
    (c, x) of shape (n_factors,).
    """
    alpha = jnp.asarray(hurst, dtype) + 0.5
    edges = np.geomspace(x_min, x_max, n_factors + 1)
    mids_np = np.sqrt(edges[:-1] * edges[1:])  # static numpy for E below
    mids = jnp.asarray(mids_np, dtype)

    # Weights by RELATIVE least squares on a log time-grid, not the
    # midpoint quadrature rule: the midpoint weights miss K(t) by 1-3%
    # pointwise, which showed up as a ~3.5% OTM wing bias in the MC
    # cross-check against the CF pricer.  Minimizing
    # sum_t |sum_j c_j e^{-x_j t} / K(t) - 1|^2 over t in [1e-4, 4] brings
    # the kernel error down to <0.1% across the fitted range.  The design
    # matrix is static; only the target K(t) = t^{alpha-1}/Gamma(alpha)
    # depends on (possibly traced) hurst, so the solve stays in-graph.
    t_grid = np.geomspace(1e-4, 4.0, 256)
    E = jnp.asarray(np.exp(-t_grid[:, None] * mids_np[None, :]),
                    dtype)                              # (T, M) static
    k_t = (jnp.asarray(t_grid, dtype) ** (alpha - 1.0)) / _gamma(alpha)
    Ew = E / k_t[:, None]                               # relative residuals
    gram = Ew.T @ Ew
    ridge = 1e-10 * jnp.trace(gram) / n_factors
    gram = gram + ridge * jnp.eye(n_factors, dtype=dtype)
    c = jnp.linalg.solve(gram, jnp.sum(Ew, axis=0))
    return c, mids


def _lift_step_factory(params: RoughHestonParams, dt, c, x, n_draw,
                       antithetic, rate, dividend, dtype):
    lam = jnp.asarray(params.lam, dtype)
    theta = jnp.asarray(params.theta, dtype)
    nu = jnp.asarray(params.nu, dtype)
    rho = jnp.asarray(params.rho, dtype)
    v0 = jnp.asarray(params.v0, dtype)
    rho_bar = jnp.sqrt(jnp.maximum(1.0 - rho * rho, 0.0))
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)) * dt
    sqdt = jnp.sqrt(dt)

    decay = jnp.exp(-x * dt)                             # (M,)
    gamma = jnp.where(x * dt > 1e-12,
                      (1.0 - decay) / (x * dt), 1.0)     # (M,)

    def step(state, k_t):
        ln_s, Y = state                                  # (P,), (P, M)
        v = jnp.maximum(v0 + Y @ c, 0.0)                 # (P,)
        k1, k2 = jax.random.split(k_t)
        dW = jax.random.normal(k1, (n_draw,), dtype) * sqdt
        dB = jax.random.normal(k2, (n_draw,), dtype) * sqdt
        if antithetic:
            dW = jnp.concatenate([dW, -dW])
            dB = jnp.concatenate([dB, -dB])
        sqv = jnp.sqrt(v)
        dF = lam * (theta - v) * dt + nu * sqv * dW      # (P,)
        Y_new = decay[None, :] * Y + gamma[None, :] * dF[:, None]
        ln_s_new = (ln_s + drift - 0.5 * v * dt
                    + sqv * (rho * dW + rho_bar * dB))
        v_new = jnp.maximum(v0 + Y_new @ c, 0.0)
        return (ln_s_new, Y_new), v_new

    return step


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "n_paths", "n_factors", "antithetic"),
)
def simulate_lifted(
    params: RoughHestonParams,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 256,
    n_paths: int = 65536,
    n_factors: int = 20,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
) -> MCPaths:
    """Simulate rough Heston paths; returns terminal state + path
    statistics (same :class:`~pde_tpu.models.heston_mc.MCPaths` contract as
    the classic QE engine, so every path-payoff pricer there applies)."""
    dtype = result_dtype(spot, maturity, params.lam)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    dt = jnp.asarray(maturity, dtype) / n_steps
    c, x = lift_nodes(params.hurst, n_factors, dtype=dtype)
    step = _lift_step_factory(params, dt, c, x, n_draw, antithetic,
                              rate, dividend, dtype)

    s0 = jnp.asarray(spot, dtype)
    state0 = (
        jnp.full((n_paths,), jnp.log(s0), dtype),
        jnp.zeros((n_paths, n_factors), dtype),
    )

    def acc_step(carry, k_t):
        state, s_sum, s_max, s_min = carry
        state_new, _ = step(state, k_t)
        s = jnp.exp(state_new[0])
        return (state_new, s_sum + s, jnp.maximum(s_max, s),
                jnp.minimum(s_min, s)), None

    init = (state0, jnp.zeros((n_paths,), dtype),
            jnp.full((n_paths,), s0, dtype), jnp.full((n_paths,), s0, dtype))
    (state, s_sum, s_max, s_min), _ = jax.lax.scan(
        acc_step, init, jax.random.split(key, n_steps)
    )
    ln_s, Y = state
    v_term = jnp.maximum(jnp.asarray(params.v0, dtype) + Y @ c, 0.0)
    return MCPaths(jnp.exp(ln_s), v_term, s_sum / n_steps, s_max, s_min)


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "n_paths", "n_factors", "antithetic"),
)
def simulate_lifted_paths(
    params: RoughHestonParams,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 256,
    n_paths: int = 65536,
    n_factors: int = 20,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
):
    """Stored-path variant: returns ``(S, V)`` of shape
    ``(n_steps, n_paths)`` at t_1..t_N — feeds the LSM backward induction
    (solvers/lsm.lsm_backward_induction) for AMERICAN options under rough
    dynamics, which neither the CF pricer nor any grid method reaches
    (the state is (n_factors+1)-dimensional)."""
    dtype = result_dtype(spot, maturity, params.lam)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    dt = jnp.asarray(maturity, dtype) / n_steps
    c, x = lift_nodes(params.hurst, n_factors, dtype=dtype)
    step = _lift_step_factory(params, dt, c, x, n_draw, antithetic,
                              rate, dividend, dtype)

    state0 = (
        jnp.full((n_paths,), jnp.log(jnp.asarray(spot, dtype)), dtype),
        jnp.zeros((n_paths, n_factors), dtype),
    )

    def path_step(state, k_t):
        state_new, v_new = step(state, k_t)
        return state_new, (state_new[0], v_new)

    _, (ln_s, v) = jax.lax.scan(path_step, state0,
                                jax.random.split(key, n_steps))
    return jnp.exp(ln_s), v


def price_european_rough_mc(
    params: RoughHestonParams,
    strikes,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 256,
    n_paths: int = 65536,
    n_factors: int = 20,
    antithetic: bool = True,
):
    """European vanilla under rough Heston by lifted MC.  Cross-validates
    the fractional-Riccati CF pricer (rough_heston.price_rough) — two
    independent numerical routes to the same model.  Returns
    ``(price, stderr)`` shaped like ``strikes``."""
    paths = simulate_lifted(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths, n_factors=n_factors,
        rate=rate, dividend=dividend, antithetic=antithetic,
    )
    dtype = paths.spot.dtype
    strikes_a = jnp.atleast_1d(jnp.asarray(strikes, dtype))
    sign = jnp.broadcast_to(
        jnp.where(jnp.asarray(is_call), 1.0, -1.0), strikes_a.shape
    ).astype(dtype)
    disc = jnp.exp(-jnp.asarray(rate, dtype) * jnp.asarray(maturity, dtype))
    payoff = jnp.maximum(
        sign[None, :] * (paths.spot[:, None] - strikes_a[None, :]), 0.0
    )
    price, stderr = _mc_estimate(disc * payoff, n_paths, antithetic)
    if jnp.ndim(strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "n_paths", "n_factors", "antithetic"),
)
def price_american_rough_lsm(
    params: RoughHestonParams,
    strike,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 128,
    n_paths: int = 65536,
    n_factors: int = 20,
    antithetic: bool = True,
):
    """American vanilla under ROUGH Heston dynamics — Longstaff-Schwartz on
    lifted paths.  Returns ``(price, stderr)``.

    This is the payoff class the MC engine exists for: the rough model's
    state is effectively infinite-dimensional (here: n_factors + 1 after
    the lift), so no PDE grid or CF method reaches American exercise.  The
    regression basis is the same (S, V) quadratic family the classic LSM
    uses (solvers/lsm._basis) — V = v0 + sum c_j Y_j is the natural
    low-dimensional summary of the lifted state for the continuation value.
    """
    from ..solvers.lsm import lsm_backward_induction

    dtype = result_dtype(spot, maturity, strike, params.lam)
    s_path, v_path = simulate_lifted_paths(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths, n_factors=n_factors,
        rate=rate, dividend=dividend, antithetic=antithetic,
    )
    sign = jnp.where(jnp.asarray(is_call), 1.0, -1.0).astype(dtype)
    dt = jnp.asarray(maturity, dtype) / n_steps
    disc = jnp.exp(-jnp.asarray(rate, dtype) * dt)
    cashflow = lsm_backward_induction(s_path, v_path, strike, sign, disc)
    price, stderr = _mc_estimate(cashflow * disc, n_paths, antithetic)
    intrinsic = jnp.maximum(
        sign * (jnp.asarray(spot, dtype) - jnp.asarray(strike, dtype)), 0.0
    )
    return jnp.maximum(price, intrinsic), stderr
