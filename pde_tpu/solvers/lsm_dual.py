"""Andersen-Broadie dual (upper-bound) estimator for LSM American pricing.

The LSM lower bound (solvers/lsm.py) values a *suboptimal* policy, so it
sits below the true American price; this module computes the matching
martingale-duality UPPER bound (Andersen & Broadie 2004; Rogers 2002), so
every price carries a rigorous confidence interval

    lower - 4 se_l  <=  true price  <=  upper + 4 se_u

— the sandwich test no grid solver can provide by itself.  The reference
framework has no American MC machinery at all (its only American route is
the per-step obstacle projection in src/cpp/solvers/black_scholes_pde.hpp:
116-124 and heston_pde.hpp:143-150).

Method.  Freeze the LSM exercise policy (the raw-space regression
coefficients collected by ``lsm_backward_induction(collect_policy=True)``).
For the duality martingale, the only conditional expectation needed at
every outer state ``X_t`` is the policy continuation value

    C_t(X_t) = E[ h_tau | X_t ],   tau = first policy exercise > t,

estimated by ``n_inner`` nested sub-simulations that follow the frozen
policy to its stopping time.  With ``V_t = h_t`` where the policy stops
(exact, no inner noise) and ``C_t`` elsewhere, the Doob decomposition

    M_t = sum_{u<=t} ( V_u(X_u) - C_{u-1}(X_{u-1}) )

is a martingale in the enlarged filtration even with inner-sample noise
(sub-sims are unbiased for the policy value), so

    price <= E[ max_t ( h_t - M_t ) ]

holds in expectation — inner noise only pushes the bound UP, never breaks
it.  All values are kept in time-0 discounted units.

Device-native design: the outer x inner bundle is one flat path axis (a
``(n_outer * n_inner,)`` QE scan per start date — the same lane-parallel
shape as every other MC engine here); the per-date Python loop unrolls into
one XLA program with static trip counts.  Cost is O(n_steps^2 / 2) QE steps
per inner path: keep ``n_steps`` at Bermudan-grade (8-32) — the dual gap it
measures is a policy-quality diagnostic, not a production pricer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype
from ..models.heston import HestonParams
from ..models.heston_mc import _make_qe_step, _qe_constants, simulate_qe_paths
from .lsm import _basis, lsm_backward_induction

__all__ = ["dual_upper_bound"]


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "n_reg_paths", "n_outer", "n_inner"),
)
def dual_upper_bound(
    params: HestonParams,
    strike,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 16,
    n_reg_paths: int = 32768,
    n_outer: int = 1024,
    n_inner: int = 64,
):
    """American option price sandwich under the frozen LSM policy.

    Returns ``(lower, se_lower, upper, se_upper)``: ``lower`` is an
    OUT-OF-SAMPLE policy valuation (fresh paths, so no in-sample peeking
    bias — it is a genuine lower bound in expectation), ``upper`` the
    Andersen-Broadie dual bound.  ``upper - lower`` is the duality gap; for
    the quadratic (S/K, v) basis on vanilla puts it is a fraction of a
    percent of the price (see tests/test_lsm_dual.py).
    """
    dtype = result_dtype(spot, maturity, strike, params.kappa)
    k_arr = jnp.asarray(strike, dtype)
    s0 = jnp.asarray(spot, dtype)
    sign = jnp.where(jnp.asarray(is_call), 1.0, -1.0).astype(dtype)
    N = n_steps
    dt = jnp.asarray(maturity, dtype) / N
    disc = jnp.exp(-jnp.asarray(rate, dtype) * dt)
    disc0 = disc ** jnp.arange(1, N + 1, dtype=dtype)  # e^{-r t_j}, j=1..N

    def payoff(s):
        return jnp.maximum(sign * (s - k_arr), 0.0)

    k_reg, k_outer, k_inner = jax.random.split(key, 3)

    # -- phase 1: fit the policy on its own path set ----------------------
    s_reg, v_reg = simulate_qe_paths(
        params, spot, maturity, k_reg,
        n_steps=N, n_paths=n_reg_paths, rate=rate, dividend=dividend)
    _, (gammas, cs) = lsm_backward_induction(
        s_reg, v_reg, strike, sign, disc, collect_policy=True)
    # pad a terminal row so date indexing u = 0..N-1 is uniform (the
    # terminal date always exercises; its row is never read)
    gammas = jnp.concatenate([gammas, jnp.zeros_like(gammas[:1])])
    cs = jnp.concatenate([cs, jnp.zeros_like(cs[:1])])

    def cont_hat(s, v, u):
        return _basis(s / k_arr, v) @ gammas[u] + cs[u]

    def policy_stops(s, v, u):
        """Exercise at date row u (0-based, dates t_1..t_N)?  Terminal row
        always exercises (payoff may be 0)."""
        intr = payoff(s)
        ex = (intr > 0.0) & (intr > cont_hat(s, v, u))
        return jnp.where(u == N - 1, True, ex)

    # -- inner continuation bundles --------------------------------------
    E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(params, dt, dtype)
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)) * dt

    def continuation(ln_s, v, start_row, k_t, n_flat):
        """Mean discounted-to-0 policy payoff of CONTINUING from state
        (ln_s, v) at date row ``start_row`` (static int; -1 = time 0).
        Simulates rows start_row+1 .. N-1 under the frozen policy."""
        qe = _make_qe_step(
            E, c1, c2, jnp.asarray(params.theta, dtype),
            k0_plain, k1, k2, k3, k4, drift,
            n_flat, False, True, dtype)
        rows = jnp.arange(start_row + 1, N)

        def step(carry, xs):
            ln_s_c, v_c, active, val = carry
            u, k_u = xs
            ln_s_n, v_n = qe(ln_s_c, v_c, k_u)
            s_n = jnp.exp(ln_s_n)
            ex = active & policy_stops(s_n, v_n, u)
            val = val + jnp.where(ex, disc0[u] * payoff(s_n), 0.0)
            return (ln_s_n, v_n, active & ~ex, val), None

        keys = jax.random.split(k_t, rows.shape[0])
        init = (ln_s, v, jnp.ones(ln_s.shape, bool),
                jnp.zeros(ln_s.shape, dtype))
        (_, _, _, val), _ = jax.lax.scan(step, init, (rows, keys))
        return val

    # -- phase 2: outer paths + h ----------------------------------------
    s_out, v_out = simulate_qe_paths(
        params, spot, maturity, k_outer,
        n_steps=N, n_paths=n_outer, rate=rate, dividend=dividend,
        antithetic=False)
    h = disc0[:, None] * payoff(s_out)                     # (N, n_outer)

    # C_0 and the out-of-sample lower bound share one bundle from X_0
    n0 = n_outer * n_inner
    k0_key, k_inner = jax.random.split(k_inner)
    val0 = continuation(
        jnp.full((n0,), jnp.log(s0), dtype),
        jnp.full((n0,), jnp.asarray(params.v0, dtype)),
        -1, k0_key, n0)
    c_prev = jnp.mean(val0)                                # scalar C_0
    lower = jnp.maximum(c_prev, payoff(s0))
    se_lower = jnp.std(val0) / jnp.sqrt(1.0 * n0)

    # -- phase 3: martingale increments date by date ---------------------
    n_flat = n_outer * n_inner
    m = jnp.zeros((n_outer,), dtype)
    g_max = jnp.full((n_outer,), -jnp.inf, dtype)
    for row in range(N):                                   # dates t_1..t_N
        s_t, v_t = s_out[row], v_out[row]
        if row < N - 1:
            k_row, k_inner = jax.random.split(k_inner)
            ln_rep = jnp.repeat(jnp.log(s_t), n_inner)
            v_rep = jnp.repeat(v_t, n_inner)
            c_here = jnp.mean(
                continuation(ln_rep, v_rep, row, k_row, n_flat)
                .reshape(n_outer, n_inner), axis=1)        # C_row(X_row)
            stops = policy_stops(s_t, v_t, row)
            v_hat = jnp.where(stops, h[row], c_here)
        else:
            v_hat = h[row]                                 # terminal: exact
            c_here = jnp.zeros_like(v_hat)
        m = m + (v_hat - c_prev)
        g_max = jnp.maximum(g_max, h[row] - m)
        c_prev = c_here
    g_max = jnp.maximum(g_max, payoff(s0))                 # exercise at t_0
    upper = jnp.mean(g_max)
    se_upper = jnp.std(g_max) / jnp.sqrt(1.0 * n_outer)
    return lower, se_lower, upper, se_upper
