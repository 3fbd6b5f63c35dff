"""American option pricing by Longstaff-Schwartz least-squares Monte Carlo.

A third, simulation-based route to the American prices the ADI LCP solver
computes on a grid (:mod:`pde_tpu.solvers.heston_adi` ``american_method=
"it_lcp"``; reference scheme src/cpp/solvers/heston_pde.hpp:143-150) — and
the only route that scales past two state dimensions.  The reference
platform has no LSM engine.

Device-native design: paths come from the stored-path QE simulation
(:func:`pde_tpu.models.heston_mc.simulate_qe_paths`), the backward
induction is one ``lax.scan`` over the time-reversed path array, and each
step's cross-sectional regression is a tiny (k x k) normal-equations solve
whose Gram matrix is an (n_paths x k)T (n_paths x k) matmul — the one spot
in the framework's MC stack that is a matrix product.  No data-dependent
control flow: ITM-path selection is a weight vector, not a gather, so the
whole pricer jits to a single XLA program.

Algorithm (Longstaff & Schwartz 2001):

1. simulate S, v on t_1..t_N,
2. at expiry V = payoff(S_N),
3. backward for t = N-1..1: regress the discounted continuation value on a
   polynomial basis in (moneyness, variance) over in-the-money paths, and
   exercise where intrinsic exceeds the fitted continuation,
4. price = E[discounted cashflow], never exercising at t_0 (the t_0
   continuation is the price itself).

The classic in-sample estimator: the same paths choose the policy and value
it.  Policy suboptimality biases it LOW, in-sample peeking biases it HIGH;
at >= 2^15 paths with the quadratic (s, v) basis both effects are well
inside the ADI solver's own 0.2% discretization band (see tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype
from ..models.heston import HestonParams
from ..models.heston_mc import _mc_estimate, simulate_qe_paths

__all__ = [
    "price_american_lsm",
    "price_american_lsm_batch",
    "lsm_backward_induction",
]

_RIDGE = 1e-7


def _basis(s_norm, v):
    """Regression features: quadratic in normalized spot, linear in variance
    plus the cross term — 6 functions. s_norm = S/K keeps the Gram matrix
    well-conditioned at any strike scale."""
    one = jnp.ones_like(s_norm)
    return jnp.stack(
        [one, s_norm, s_norm * s_norm, s_norm**3, v, s_norm * v], axis=-1
    )


def _reduce_sum(x, axis_name):
    """Sum over local paths, then over the mesh axis when one is named.

    Every regression moment in the backward induction is a plain sum over
    the path cross-section, so sharding the path axis over devices costs
    exactly one fused ``psum`` of ~50 scalars per time step — the
    cross-sectional regression becomes a distributed normal-equations solve
    with bit-identical policy on every shard (up to reduction order)."""
    s = jnp.sum(x, axis=0)
    if axis_name is not None:
        s = jax.lax.psum(s, axis_name)
    return s


def lsm_backward_induction(
    s_path, v_path, strike, sign, disc, *, axis_name=None,
    collect_policy: bool = False,
):
    """Longstaff-Schwartz backward induction over stored paths.

    ``s_path``/``v_path`` are ``(n_steps, n_local_paths)`` — the LOCAL shard
    when called inside ``shard_map`` with ``axis_name`` set, in which case
    the regression is computed over the GLOBAL cross-section via ``psum``
    of the Gram/moment sums.  Returns the per-path cashflow at t_1
    (discounted to t_1; callers discount the final step to t_0).

    With ``collect_policy=True`` also returns ``(gamma, c)`` arrays of
    shape ``(n_steps - 1, F)`` / ``(n_steps - 1,)`` in DATE order
    (t_1..t_{N-1}): the fitted continuation in raw feature space,
    ``cont_hat = basis(S/K, v) @ gamma[t] + c[t]`` — the frozen exercise
    policy consumed by the Andersen-Broadie dual bound (solvers/lsm_dual).
    """
    dtype = s_path.dtype
    k_arr = jnp.asarray(strike, dtype)
    sign = jnp.asarray(sign, dtype)

    def payoff(s):
        return jnp.maximum(sign * (s - k_arr), 0.0)

    v_terminal = payoff(s_path[-1])
    xs = (s_path[:-1][::-1], v_path[:-1][::-1])

    def backward(cashflow, x):
        s_t, v_t = x
        cont = cashflow * disc  # continuation value discounted to t
        intrinsic = payoff(s_t)
        w = (intrinsic > 0).astype(dtype)  # regress over ITM paths only
        phi = _basis(s_t / k_arr, v_t)
        n_itm = jnp.maximum(_reduce_sum(w, axis_name), 1.0)
        # standardize the non-constant features over the ITM cross-section:
        # raw polynomial features span ~1..700, and in float32 the resulting
        # Gram matrix is ill-conditioned enough that jnp.linalg.solve
        # produces a garbage policy for unlucky draws (observed: an 11%
        # price error at 2^14 paths).  On the standardized scale a
        # scale-relative ridge is safe.
        mu = _reduce_sum(phi * w[:, None], axis_name) / n_itm
        var = _reduce_sum((phi - mu) ** 2 * w[:, None], axis_name) / n_itm
        sd = jnp.sqrt(jnp.maximum(var, _RIDGE))
        is_const = jnp.arange(phi.shape[-1]) == 0
        mu = jnp.where(is_const, 0.0, mu)
        sd = jnp.where(is_const, 1.0, sd)
        phi = (phi - mu) / sd
        wphi = phi * w[:, None]
        gram = wphi.T @ phi  # local (k x k) Gram as a matmul ...
        if axis_name is not None:
            gram = jax.lax.psum(gram, axis_name)  # ... then one tiny psum
        gram = gram / n_itm
        ridge = 1e-4 * jnp.trace(gram) / phi.shape[-1]
        gram = gram + ridge * jnp.eye(phi.shape[-1], dtype=dtype)
        rhs = _reduce_sum(wphi * cont[:, None], axis_name) / n_itm
        beta = jnp.linalg.solve(gram, rhs)
        cont_hat = phi @ beta
        exercise = (intrinsic > cont_hat) & (w > 0)
        # raw-space policy: cont_hat = basis @ gamma + c (standardization
        # folded into the coefficients) — tiny per-step output, collected
        # regardless so the scan body stays identical either way
        gamma = beta / sd
        c = -jnp.sum(mu * gamma)
        return jnp.where(exercise, intrinsic, cont), (gamma, c)

    cashflow, (gammas, cs) = jax.lax.scan(backward, v_terminal, xs)
    if collect_policy:
        return cashflow, (gammas[::-1], cs[::-1])
    return cashflow


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "n_paths", "antithetic", "simulate_paths_fn"),
)
def price_american_lsm(
    params: HestonParams,
    strike,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=False,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_paths_fn=None,
):
    """American vanilla via Longstaff-Schwartz.  Returns ``(price, stderr)``.

    Exercise is allowed at the ``n_steps`` equispaced dates t_1..t_N — a
    Bermudan approximation converging to the American price as ``n_steps``
    grows (the ADI solver's time grid makes the same approximation,
    reference heston_pde.hpp:143-150).

    ``simulate_paths_fn`` swaps the path generator (same signature as
    :func:`~pde_tpu.models.heston_mc.simulate_qe_paths`) — e.g. the Bates
    jump-overlay stored-path simulator (models/bates.py), giving American
    exercise under jump risk; the regression/backward-induction machinery
    is model-agnostic in (S, v) paths.
    """
    dtype = result_dtype(spot, maturity, strike, params.kappa)
    s_path, v_path = (simulate_paths_fn or simulate_qe_paths)(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths,
        rate=rate, dividend=dividend, antithetic=antithetic,
    )
    sign = jnp.where(jnp.asarray(is_call), 1.0, -1.0).astype(dtype)
    dt = jnp.asarray(maturity, dtype) / n_steps
    disc = jnp.exp(-jnp.asarray(rate, dtype) * dt)

    cashflow = lsm_backward_induction(s_path, v_path, strike, sign, disc)
    discounted = cashflow * disc  # discount t_1 -> t_0

    def payoff(s):
        return jnp.maximum(sign * (s - jnp.asarray(strike, dtype)), 0.0)
    # antithetic pairs are correlated — fold before the stderr (heston_mc)
    price, stderr = _mc_estimate(discounted, n_paths, antithetic)
    # exercise at t_0 itself: deep ITM, the continuation estimate can sit
    # below intrinsic — the American holder would exercise immediately
    price = jnp.maximum(price, payoff(jnp.asarray(spot, dtype)))
    return price, stderr


@functools.partial(
    jax.jit, static_argnames=("n_steps", "n_paths", "antithetic")
)
def price_american_lsm_batch(
    params: HestonParams,
    strikes,
    is_call,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
):
    """A whole American book off ONE path set, with the book axis as a matmul dimension.

    The naive batching (vmap the single-contract induction over strikes)
    materializes a weighted ``(n_paths, 6)`` feature copy PER STRIKE every
    step — measured only ~3.7x faster than looping singles at B=128.  This
    implementation instead keeps one strike-independent feature matrix
    ``phi (n_paths, 6)`` per step (the regression prediction is invariant
    to scaling the spot feature, and standardization absorbs the per-strike
    S/K normalization exactly), and computes EVERY contract's regression
    moments as three matmuls with the book axis as the matmul M dimension:

        Sraw = w^T  @ (phi ⊗ phi)   (B, 6, 6)  all Gram matrices at once
        m1   = w^T  @ phi           (B, 6)     all ITM feature means
        Sc   = (w·cont)^T @ phi     (B, 6)     all regression targets

    followed by the closed-form standardization algebra, one batched 6x6
    solve, and one ``phi @ gamma^T`` matmul broadcasting every fitted
    continuation back over all paths.  Each contract still gets its OWN
    exercise-policy regression over its OWN ITM set; only the underlying
    paths are shared (which correlates estimates across strikes but biases
    none of them).  ``strikes``/``is_call`` broadcast to the book shape;
    returns ``(prices, stderrs)`` with that shape.
    """
    strikes = jnp.atleast_1d(jnp.asarray(strikes))
    sign_in = jnp.where(jnp.asarray(is_call), 1.0, -1.0)
    strikes_b, sign_b = jnp.broadcast_arrays(strikes, sign_in)
    book_shape = strikes_b.shape
    dtype = result_dtype(spot, maturity, strikes, params.kappa)
    k_vec = strikes_b.astype(dtype).ravel()          # (B,)
    sg_vec = sign_b.astype(dtype).ravel()            # (B,)

    s_path, v_path = simulate_qe_paths(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths,
        rate=rate, dividend=dividend, antithetic=antithetic,
    )
    dt = jnp.asarray(maturity, dtype) / n_steps
    disc = jnp.exp(-jnp.asarray(rate, dtype) * dt)
    s0 = jnp.asarray(spot, dtype)
    F = 6

    def payoff(s):  # (P,) -> (P, B)
        return jnp.maximum(sg_vec[None, :] * (s[:, None] - k_vec[None, :]), 0.0)

    v_terminal = payoff(s_path[-1])
    xs = (s_path[:-1][::-1], v_path[:-1][::-1])

    def backward(cashflow, x):  # cashflow (P, B)
        s_t, v_t = x
        cont = cashflow * disc
        intrinsic = payoff(s_t)                      # (P, B)
        w = (intrinsic > 0).astype(dtype)            # (P, B)
        phi = _basis(s_t / s0, v_t)                  # (P, F) — shared
        n_itm = jnp.maximum(jnp.sum(w, axis=0), 1.0)  # (B,)

        outer = (phi[:, :, None] * phi[:, None, :]).reshape(-1, F * F)
        sraw = (w.T @ outer).reshape(-1, F, F)       # (B, F, F)
        m1 = w.T @ phi                               # (B, F)
        sc_vec = (w * cont).T @ phi                  # (B, F)
        sc_sum = jnp.sum(w * cont, axis=0)           # (B,)
        sum_w = jnp.sum(w, axis=0)                   # (B,) unclamped

        mu = m1 / n_itm[:, None]
        var = jnp.diagonal(sraw, axis1=1, axis2=2) / n_itm[:, None] - mu * mu
        sd = jnp.sqrt(jnp.maximum(var, _RIDGE))
        is_const = jnp.arange(F) == 0
        mu = jnp.where(is_const[None, :], 0.0, mu)
        sd = jnp.where(is_const[None, :], 1.0, sd)

        # standardized Gram/rhs from the raw sums — the full bilinear
        # expansion sum w (phi_a - mu_a)(phi_b - mu_b) with EXPLICIT first
        # moments m1 (the const column's mu is forced to 0 above, so the
        # shortcut Sraw - n mu mu^T would be wrong in its row/column);
        # exactly the per-strike (phi-mu)/sd regression of the
        # single-contract path:
        gram = (sraw
                - mu[:, :, None] * m1[:, None, :]
                - mu[:, None, :] * m1[:, :, None]
                + sum_w[:, None, None] * mu[:, :, None] * mu[:, None, :])
        gram = gram / (n_itm[:, None, None] * sd[:, :, None] * sd[:, None, :])
        ridge = 1e-4 * jnp.trace(gram, axis1=1, axis2=2) / F
        gram = gram + ridge[:, None, None] * jnp.eye(F, dtype=dtype)[None]
        rhs = (sc_vec - mu * sc_sum[:, None]) / (sd * n_itm[:, None])

        beta = jnp.linalg.solve(gram, rhs[..., None])[..., 0]  # (B, F)
        gamma = beta / sd                                      # (B, F)
        c = -jnp.sum(mu * gamma, axis=-1)                      # (B,)
        cont_hat = phi @ gamma.T + c[None, :]                  # (P, B)

        exercise = (intrinsic > cont_hat) & (w > 0)
        return jnp.where(exercise, intrinsic, cont), None

    cashflow, _ = jax.lax.scan(backward, v_terminal, xs)
    prices, stderrs = _mc_estimate(cashflow * disc, n_paths, antithetic)
    intrinsic0 = jnp.maximum(sg_vec * (s0 - k_vec), 0.0)
    prices = jnp.maximum(prices, intrinsic0)
    return prices.reshape(book_shape), stderrs.reshape(book_shape)
