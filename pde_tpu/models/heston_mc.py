"""Heston Monte Carlo engine — Andersen (2008) Quadratic-Exponential scheme.

An independent, simulation-based pricing path for the same model the
characteristic-function pricer (:mod:`pde_tpu.models.heston`, reference
src/cpp/models/heston.{hpp,cpp}) and the ADI PDE solver
(:mod:`pde_tpu.solvers.heston_adi`, reference src/cpp/solvers/heston_pde.hpp)
implement.  The reference platform has **no** Monte Carlo option pricer (its
only MC is the backtest bootstrap, backtesting/analysis.py:631-841, and the
VaR simulator, risk/var_calculator.py:241-505); this module extends the
framework to path-dependent payoffs those engines cannot price — discretely
monitored barriers, arithmetic Asians, lookbacks — while cross-validating the
quadrature and PDE prices on Europeans.

Device-native design: the path axis is the vector axis (a ``(n_paths,)`` state
carried through one ``lax.scan`` over time steps), so every step is a fused
elementwise vector op across all paths at once; path-dependent statistics
(running average / max / min) are O(1)-memory scan accumulators, never
``(n_paths, n_steps)`` materializations.  Antithetic variates come free as a
``concatenate([z, -z])`` on the vector axis; the martingale control variate
(discounted terminal spot) removes most residual discretization bias on
European payoffs.

Scheme: Andersen (2008), "Efficient simulation of the Heston stochastic
volatility process", QE with martingale correction:

* variance: moment-matched quadratic (``psi <= psi_c``) or
  exponential-mass-at-zero (``psi > psi_c``) sampling of the exact CIR
  transition's first two moments,
* log-spot: central discretization (gamma1 = gamma2 = 1/2) with the
  broken-drift ``K0*`` chosen per path so the discounted spot is an exact
  discrete martingale (Andersen section 4.2, eqs. 37-40).

Both branches are evaluated and selected with ``jnp.where`` — no
data-dependent control flow, so the whole simulation is one XLA program.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core import qmc
from ..core.precision import result_dtype
from .heston import HestonParams

__all__ = [
    "MCPaths",
    "simulate_qe",
    "simulate_qe_paths",
    "price_european_mc",
    "price_asian_mc",
    "price_barrier_mc",
    "price_lookback_mc",
    "price_path_payoff_mc",
    "price_forward_start_mc",
    "price_cliquet_mc",
    "greeks_european_mc",
]

PSI_CRIT = 1.5  # Andersen's psi_c switching threshold (section 3.2.4)
_TINY = 1e-12


class MCPaths(NamedTuple):
    """Terminal state + path statistics of one QE simulation.

    All fields are ``(n_paths,)`` vectors.  ``s_avg`` is the arithmetic
    average of the spot over the ``n_steps`` monitoring dates (t_1 .. t_N =
    T, excluding t_0); ``s_max``/``s_min`` include the initial spot.
    """

    spot: jnp.ndarray
    variance: jnp.ndarray
    s_avg: jnp.ndarray
    s_max: jnp.ndarray
    s_min: jnp.ndarray
    # Brownian-bridge survival probability w.r.t. a continuous barrier
    # (populated only when simulate_qe is given a ``barrier``; None otherwise)
    survival: jnp.ndarray | None = None


def _qe_constants(params: HestonParams, dt, dtype):
    """Per-step constants of the QE scheme (independent of the state)."""
    kappa = jnp.asarray(params.kappa, dtype)
    theta = jnp.asarray(params.theta, dtype)
    sigma = jnp.asarray(params.sigma, dtype)
    rho = jnp.asarray(params.rho, dtype)

    E = jnp.exp(-kappa * dt)  # exp(-kappa*Delta)
    one_mE = 1.0 - E
    sig2 = sigma * sigma
    # CIR conditional-moment coefficients:  m = theta + (v - theta) E,
    # s^2 = c1 * v + c2   (Andersen eqs. 17-18)
    c1 = sig2 * E * one_mE / kappa
    c2 = theta * sig2 * one_mE * one_mE / (2.0 * kappa)

    gamma1 = gamma2 = 0.5  # central discretization
    k1 = gamma1 * dt * (kappa * rho / sigma - 0.5) - rho / sigma
    k2 = gamma2 * dt * (kappa * rho / sigma - 0.5) + rho / sigma
    k3 = gamma1 * dt * (1.0 - rho * rho)
    k4 = gamma2 * dt * (1.0 - rho * rho)
    # non-martingale drift constant (used when martingale correction is off)
    k0 = -rho * kappa * theta * dt / sigma
    return E, c1, c2, k0, k1, k2, k3, k4


def _qe_variance_draw(v, u, E, c1, c2, theta, psi_c, dtype):
    """One QE variance transition: v_t -> v_{t+dt} given a uniform draw.

    Returns (v_new, a, b2, p, beta, is_quad) — the branch intermediates are
    needed again by the martingale K0* correction.
    """
    m = theta + (v - theta) * E
    m = jnp.maximum(m, _TINY)
    s2 = c1 * v + c2
    psi = s2 / (m * m)

    # quadratic branch (psi <= psi_c):  v+ = a (b + Z)^2
    inv_psi2 = 2.0 / jnp.maximum(psi, _TINY)
    b2 = jnp.maximum(
        inv_psi2 - 1.0 + jnp.sqrt(jnp.maximum(inv_psi2 * (inv_psi2 - 1.0), 0.0)),
        0.0,
    )
    a = m / (1.0 + b2)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    u_c = jnp.clip(u, eps, 1.0 - eps)
    z_v = jax.scipy.special.ndtri(u_c)
    v_quad = a * (jnp.sqrt(b2) + z_v) ** 2

    # exponential branch (psi > psi_c): mass p at zero + exponential tail
    p = jnp.clip((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-6)
    beta = (1.0 - p) / m
    v_exp = jnp.where(
        u_c <= p,
        0.0,
        jnp.log((1.0 - p) / jnp.maximum(1.0 - u_c, _TINY)) / beta,
    )

    is_quad = psi <= psi_c
    v_new = jnp.where(is_quad, v_quad, v_exp)
    return v_new, a, b2, p, beta, is_quad


def _qe_k0_star(v, a, b2, p, beta, is_quad, k1, k2, k3, k4):
    """Martingale-corrected drift constant K0* (Andersen eqs. 37-40).

    Chosen so  E[exp(K0* + K1 v + K2 v' + sqrt(K3 v + K4 v') Z)] = 1
    exactly under the discrete scheme, making the discounted spot a
    discrete martingale.
    """
    A = k2 + 0.5 * k4
    # quadratic branch:  -A b^2 a / (1 - 2 A a) + 0.5 log(1 - 2 A a)
    one_m2Aa = jnp.maximum(1.0 - 2.0 * A * a, _TINY)
    k0_quad = -A * b2 * a / one_m2Aa + 0.5 * jnp.log(one_m2Aa)
    # exponential branch: -log(p + beta (1 - p) / (beta - A))
    beta_mA = jnp.maximum(beta - A, _TINY)
    k0_exp = -jnp.log(jnp.maximum(p + beta * (1.0 - p) / beta_mA, _TINY))
    k0 = jnp.where(is_quad, k0_quad, k0_exp)
    return k0 - (k1 + 0.5 * k3) * v


def _sampler_scan_inputs(sampler, key, n_steps, antithetic):
    """Per-step scan inputs for a sampler: PRNG keys (pseudo) or scrambled
    Sobol direction-number slices + digital shifts (sobol; Matousek LMS+shift
    randomization keyed by ``key``, dims (2t, 2t+1) feed step t)."""
    if sampler == "sobol":
        if antithetic:
            raise ValueError(
                "sampler='sobol' already stratifies; antithetic sampling "
                "does not compose with it — pass antithetic=False"
            )
        dv = qmc.sobol_direction_numbers(2 * n_steps)
        k_lms, k_shift = jax.random.split(key)
        dv_s = qmc.scramble_direction_numbers(dv, k_lms)
        shifts = jax.random.bits(k_shift, (2 * n_steps,), dtype=jnp.uint32)
        return (dv_s.reshape(n_steps, 2, -1), shifts.reshape(n_steps, 2))
    if sampler != "pseudo":
        raise ValueError(f"unknown sampler {sampler!r}")
    return jax.random.split(key, n_steps)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_steps", "n_paths", "antithetic", "martingale_correction", "sampler",
        "barrier_direction",
    ),
)
def simulate_qe(
    params: HestonParams,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 64,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    martingale_correction: bool = True,
    sampler: str = "pseudo",
    barrier=None,
    barrier_direction: str = "up",
) -> MCPaths:
    """Simulate ``n_paths`` Heston paths to ``maturity`` with the QE scheme.

    With ``antithetic=True`` the second half of the path axis mirrors the
    first (``Z -> -Z``, ``U -> 1 - U``); ``n_paths`` must then be even.
    ``sampler="sobol"`` draws each path as one point of a randomized
    ``2*n_steps``-dimensional Sobol sequence instead (requires
    ``antithetic=False``; ``key`` selects the randomization).
    Returns terminal state plus running average/max/min statistics — enough
    for European, Asian, barrier, and lookback payoffs with O(paths) memory.

    With a ``barrier`` level, the returned :class:`MCPaths` additionally
    carries per-path ``survival`` — the Brownian-bridge probability that the
    path never touched the barrier *between* monitoring dates, conditional on
    the simulated skeleton (Gobet's conditional continuity correction; the
    bridge variance over a step is the QE scheme's own conditional log-spot
    variance ``K3 v + K4 v'``).  A path whose skeleton itself crosses gets
    survival 0, so ``E[payoff * survival]`` estimates the *continuously*
    monitored knock-out without the O(1/sqrt(n_steps)) discrete-monitoring
    bias.
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    dt = jnp.asarray(maturity, dtype) / n_steps
    E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(params, dt, dtype)
    theta = jnp.asarray(params.theta, dtype)
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)) * dt

    s0 = jnp.asarray(spot, dtype)
    ln_s0 = jnp.log(s0)
    state0 = (
        jnp.full((n_paths,), ln_s0, dtype),
        jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype),
        jnp.zeros((n_paths,), dtype),  # running sum of S over monitoring dates
        jnp.full((n_paths,), s0, dtype),  # running max (includes S_0)
        jnp.full((n_paths,), s0, dtype),  # running min
        jnp.ones((n_paths,), dtype),  # bridge survival (stays 1 w/o barrier)
    )
    step_xs = _sampler_scan_inputs(sampler, key, n_steps, antithetic)

    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
        sampler=sampler, n_paths=n_paths,
    )
    if barrier is not None:
        ln_b = jnp.log(jnp.asarray(barrier, dtype))

    def step(state, k_t):
        ln_s, v, s_sum, s_max, s_min, surv = state
        ln_s_new, v_new = qe_step(ln_s, v, k_t)
        s = jnp.exp(ln_s_new)
        if barrier is not None:
            # one-touch probability of the Brownian bridge between skeleton
            # points, with the step's conditional log-spot variance
            w = jnp.maximum(k3 * v + k4 * v_new, _TINY)
            if barrier_direction == "up":
                g1, g2 = ln_b - ln_s, ln_b - ln_s_new
            else:
                g1, g2 = ln_s - ln_b, ln_s_new - ln_b
            alive = (g1 > 0.0) & (g2 > 0.0)
            p_no_cross = -jnp.expm1(-2.0 * g1 * g2 / w)
            surv = surv * jnp.where(alive, p_no_cross, 0.0)
        return (
            ln_s_new,
            v_new,
            s_sum + s,
            jnp.maximum(s_max, s),
            jnp.minimum(s_min, s),
            surv,
        ), None

    (ln_s, v, s_sum, s_max, s_min, surv), _ = jax.lax.scan(step, state0, step_xs)
    return MCPaths(
        jnp.exp(ln_s), v, s_sum / n_steps, s_max, s_min,
        surv if barrier is not None else None,
    )


def _make_qe_step(
    E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
    n_draw, antithetic, martingale_correction, dtype,
    sampler="pseudo", n_paths=None,
):
    """One QE transition (ln_s, v, xs_t) -> (ln_s', v') as a scan-body
    closure, shared between the accumulator simulation (:func:`simulate_qe`)
    and the stored-path simulation (:func:`simulate_qe_paths`).

    ``xs_t`` is the per-step scan input: a PRNG key under the pseudo-random
    sampler, or a ``(dv_slice (2, 32), shift (2,))`` pair of scrambled Sobol
    direction numbers + digital shift under ``sampler="sobol"`` (one QMC
    dimension pair per time step; the path index is the point index).
    """
    if sampler == "sobol":
        g = qmc.gray_codes(n_paths)  # hoisted: point index == path index

    def qe_step(ln_s, v, xs_t):
        if sampler == "sobol":
            dv_t, shift_t = xs_t
            x = qmc.sobol_uint32_from_gray(g, dv_t, shift_t)
            u = qmc.to_unit(x[:, 0], dtype)
            z_s = jax.scipy.special.ndtri(qmc.to_unit(x[:, 1], dtype))
        else:
            k_u, k_z = jax.random.split(xs_t)
            u = jax.random.uniform(k_u, (n_draw,), dtype)
            z_s = jax.random.normal(k_z, (n_draw,), dtype)
            if antithetic:
                u = jnp.concatenate([u, 1.0 - u])
                z_s = jnp.concatenate([z_s, -z_s])

        v_new, a, b2, p, beta, is_quad = _qe_variance_draw(
            v, u, E, c1, c2, theta, PSI_CRIT, dtype
        )
        if martingale_correction:
            k0 = _qe_k0_star(v, a, b2, p, beta, is_quad, k1, k2, k3, k4)
        else:
            k0 = k0_plain
        # Safe sqrt: on Feller-violating paths the variance is absorbed at
        # exactly 0 and sqrt'(0) = inf would turn every parameter tangent
        # into NaN under jvp (greeks_european_mc).  The double-where keeps
        # the primal identical and gives the a.e.-correct 0 tangent there.
        var_s = k3 * v + k4 * v_new
        pos = var_s > 0.0
        vol = jnp.where(pos, jnp.sqrt(jnp.where(pos, var_s, 1.0)), 0.0)
        ln_s_new = ln_s + drift + k0 + k1 * v + k2 * v_new + vol * z_s
        return ln_s_new, v_new

    return qe_step


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_steps", "n_paths", "antithetic", "martingale_correction", "sampler",
    ),
)
def simulate_qe_paths(
    params: HestonParams,
    spot,
    maturity,
    key,
    *,
    n_steps: int = 64,
    n_paths: int = 65536,
    rate=0.0,
    dividend=0.0,
    antithetic: bool = True,
    martingale_correction: bool = True,
    sampler: str = "pseudo",
):
    """Full stored-path QE simulation: returns ``(S, v)`` with shape
    ``(n_steps, n_paths)`` at the monitoring dates t_1 .. t_N = maturity
    (t_0 is the deterministic initial state, not stored).

    O(n_steps * n_paths) memory — use :func:`simulate_qe`'s scan
    accumulators when only path statistics are needed.  This variant feeds
    backward-induction algorithms (Longstaff-Schwartz American pricing,
    :mod:`pde_tpu.solvers.lsm`).
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    if antithetic and n_paths % 2:
        raise ValueError("antithetic sampling needs an even n_paths")
    n_draw = n_paths // 2 if antithetic else n_paths

    dt = jnp.asarray(maturity, dtype) / n_steps
    E, c1, c2, k0_plain, k1, k2, k3, k4 = _qe_constants(params, dt, dtype)
    theta = jnp.asarray(params.theta, dtype)
    drift = (jnp.asarray(rate, dtype) - jnp.asarray(dividend, dtype)) * dt

    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_draw, antithetic, martingale_correction, dtype,
        sampler=sampler, n_paths=n_paths,
    )

    ln_s0 = jnp.full((n_paths,), jnp.log(jnp.asarray(spot, dtype)), dtype)
    v0 = jnp.full((n_paths,), jnp.asarray(params.v0, dtype), dtype)

    def step(state, xs_t):
        ln_s, v = state
        ln_s_new, v_new = qe_step(ln_s, v, xs_t)
        return (ln_s_new, v_new), (ln_s_new, v_new)

    _, (ln_s_path, v_path) = jax.lax.scan(
        step, (ln_s0, v0), _sampler_scan_inputs(sampler, key, n_steps, antithetic)
    )
    return jnp.exp(ln_s_path), v_path


def _mc_estimate(discounted, n_paths, antithetic=False):
    """Mean and standard error of a discounted payoff sample (path axis 0).

    With antithetic sampling the 2N paths are N correlated (path, mirror)
    pairs laid out [first half | mirrored half]; treating them as 2N i.i.d.
    samples miscalibrates the standard error (over-reports when the pair
    covariance is negative — ~33% for an ATM call — and under-reports when
    it is positive).  The i.i.d. units are the pair means, so fold each
    pair first; the price itself is unchanged by the fold.
    """
    if antithetic:
        n = n_paths // 2
        discounted = 0.5 * (discounted[:n] + discounted[n:])
    else:
        n = n_paths
    price = jnp.mean(discounted, axis=0)
    stderr = jnp.std(discounted, axis=0, ddof=1) / jnp.sqrt(float(n))
    return price, stderr


def _discounted_payoff(
    paths, payoff_fn, spot, maturity, rate, dividend, control_variate
):
    """Discounted (and optionally control-variate-adjusted) payoff matrix.

    Returns ``(y, squeeze)`` with ``y`` always 2-D ``(n, k)``; ``squeeze``
    records whether the payoff was scalar-per-path.
    """
    dtype = paths.spot.dtype
    disc = jnp.exp(-jnp.asarray(rate, dtype) * jnp.asarray(maturity, dtype))
    payoff = jnp.asarray(payoff_fn(paths), dtype)
    y = disc * payoff
    squeeze = y.ndim == 1
    if squeeze:
        y = y[:, None]

    if control_variate:
        x = disc * paths.spot
        x_mean_true = jnp.asarray(spot, dtype) * jnp.exp(
            -jnp.asarray(dividend, dtype) * jnp.asarray(maturity, dtype)
        )
        x_c = x - jnp.mean(x)
        var_x = jnp.mean(x_c * x_c)
        b = jnp.mean(x_c[:, None] * (y - jnp.mean(y, axis=0)), axis=0) / (
            var_x + _TINY
        )
        y = y - b[None, :] * (x[:, None] - x_mean_true)
    return y, squeeze


def price_path_payoff_mc(
    params: HestonParams,
    payoff_fn: Callable[[MCPaths], jnp.ndarray],
    spot,
    maturity,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = False,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
):
    """Price an arbitrary path payoff ``payoff_fn(MCPaths) -> (n_paths, ...)``.

    Returns ``(price, stderr)``.  With ``control_variate=True`` the
    discounted terminal spot (a discrete martingale under the corrected QE
    scheme, with known mean ``S0 e^{-q T}``) is regressed out of the payoff,
    which typically cuts the variance of delta-one-ish payoffs by 5-50x.

    ``sampler="sobol"`` switches to replicated randomized QMC: the path
    budget is split into ``n_replicates`` independently scrambled Sobol
    batches (antithetic is ignored — the net stratification replaces it);
    the price is the replicate mean and the standard error is estimated
    across replicate means, which is the statistically sound error estimate
    for QMC (per-path variance formulas are meaningless for correlated
    low-discrepancy points).

    ``simulate_fn`` swaps the path generator (same signature as
    :func:`simulate_qe`) — e.g. the Bates jump-overlay simulator
    (models/bates.py); the estimator machinery is model-agnostic, and the
    control variate stays valid for any generator whose discounted terminal
    spot is a martingale (compensated jumps are).  A ``simulate_fn`` must
    accept the ``sampler`` keyword to be used with QMC.
    """
    sim = simulate_fn or simulate_qe
    if sampler == "sobol":
        if n_paths % n_replicates:
            raise ValueError(
                f"n_paths={n_paths} not divisible by n_replicates={n_replicates}"
            )
        m = n_paths // n_replicates

        squeeze_box = []

        def replicate_mean(k):
            paths = sim(
                params, spot, maturity, k,
                n_steps=n_steps, n_paths=m, rate=rate, dividend=dividend,
                antithetic=False, sampler="sobol",
            )
            y, sq = _discounted_payoff(
                paths, payoff_fn, spot, maturity, rate, dividend,
                control_variate,
            )
            squeeze_box.append(sq)  # static: identical across replicates
            return jnp.mean(y, axis=0)

        keys = jax.random.split(key, n_replicates)
        means = jax.vmap(replicate_mean)(keys)
        squeeze = squeeze_box[0]
        price = jnp.mean(means, axis=0)
        stderr = jnp.std(means, axis=0, ddof=1) / jnp.sqrt(
            float(n_replicates)
        )
        if squeeze:
            return price[0], stderr[0]
        return price, stderr

    paths = sim(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths, rate=rate, dividend=dividend,
        antithetic=antithetic,
    )
    y, squeeze = _discounted_payoff(
        paths, payoff_fn, spot, maturity, rate, dividend, control_variate
    )
    price, stderr = _mc_estimate(y, n_paths, antithetic)
    if squeeze:
        return price[0], stderr[0]
    return price, stderr


def price_european_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
):
    """European vanilla via QE MC.  Cross-validates the Carr-Madan pricer
    (models/heston.py, reference heston.cpp:94-151).  Returns (price, stderr)
    arrays shaped like ``strikes``."""
    strikes_a = jnp.atleast_1d(jnp.asarray(strikes))
    sign = jnp.where(jnp.asarray(is_call), 1.0, -1.0)
    sign = jnp.broadcast_to(sign, strikes_a.shape)

    def payoff(paths: MCPaths):
        return jnp.maximum(
            sign[None, :] * (paths.spot[:, None] - strikes_a[None, :]), 0.0
        )

    price, stderr = price_path_payoff_mc(
        params, payoff, spot, maturity, key,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=control_variate,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )
    if jnp.ndim(strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


def price_asian_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
):
    """Arithmetic-average (Asian) option, averaging over the ``n_steps``
    equispaced monitoring dates t_1..t_N = T.  Returns (price, stderr)."""
    strikes_a = jnp.atleast_1d(jnp.asarray(strikes))
    sign = jnp.broadcast_to(
        jnp.where(jnp.asarray(is_call), 1.0, -1.0), strikes_a.shape
    )

    def payoff(paths: MCPaths):
        return jnp.maximum(
            sign[None, :] * (paths.s_avg[:, None] - strikes_a[None, :]), 0.0
        )

    price, stderr = price_path_payoff_mc(
        params, payoff, spot, maturity, key,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=control_variate,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )
    if jnp.ndim(strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


def price_barrier_mc(
    params: HestonParams,
    strike,
    barrier,
    maturity,
    spot,
    key,
    *,
    barrier_type: str = "up-and-out",
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    continuity_correction: bool = False,
):
    """Barrier option via QE MC.  Returns (price, stderr).

    ``barrier_type``: up-and-out / up-and-in / down-and-out / down-and-in.

    Default (``continuity_correction=False``): the *discretely* monitored
    contract, knocked on the ``n_steps`` simulation dates (plus t_0) — no
    Broadie-Glasserman-Kou adjustment; refine ``n_steps`` toward the
    continuous limit.

    ``continuity_correction=True`` prices the *continuously* monitored
    contract at the same ``n_steps``: each path is weighted by its
    Brownian-bridge no-touch probability (see :func:`simulate_qe`), removing
    the O(1/sqrt(n_steps)) monitoring bias.  Cross-checked against the
    absorbing-boundary ADI solver (solvers/barrier_pde.py).  Only the
    built-in QE simulator supports it (``simulate_fn`` must be None).
    """
    direction, _, inout = barrier_type.partition("-and-")
    if direction not in ("up", "down") or inout not in ("in", "out"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    sign = 1.0 if is_call else -1.0

    if continuity_correction:
        if simulate_fn is not None:
            raise ValueError(
                "continuity_correction is only supported with the built-in "
                "QE simulator (simulate_fn=None)"
            )
        simulate_fn = functools.partial(
            simulate_qe, barrier=barrier, barrier_direction=direction
        )

        def payoff(paths: MCPaths):
            vanilla = jnp.maximum(sign * (paths.spot - strike), 0.0)
            weight = paths.survival if inout == "out" else 1.0 - paths.survival
            return vanilla * weight

    else:

        def payoff(paths: MCPaths):
            if direction == "up":
                knocked = paths.s_max >= barrier
            else:
                knocked = paths.s_min <= barrier
            alive = knocked if inout == "in" else ~knocked
            vanilla = jnp.maximum(sign * (paths.spot - strike), 0.0)
            return jnp.where(alive, vanilla, 0.0)

    return price_path_payoff_mc(
        params, payoff, spot, maturity, key,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=False,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )


def price_digital_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    kind: str = "cash",
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
):
    """Digital (binary) option via QE MC.  Returns (price, stderr).

    ``kind="cash"`` pays 1 at expiry in the money; ``kind="asset"`` pays
    S_T.  MC twin of the Gil-Pelaez semi-analytic pricer
    (models/digital.py) — the payoff indicator is discontinuous, so use
    the analytic pricer (or its AD) for Greeks; this estimator is for
    price cross-checks and models with no tractable CF (simulate_fn).
    """
    if kind not in ("cash", "asset"):
        raise ValueError(f"kind must be 'cash' or 'asset', got {kind!r}")
    strikes_a = jnp.atleast_1d(jnp.asarray(strikes))
    sign = jnp.broadcast_to(
        jnp.where(jnp.asarray(is_call), 1.0, -1.0), strikes_a.shape
    )

    def payoff(paths: MCPaths):
        in_money = sign * (paths.spot[:, None] - strikes_a) > 0.0
        unit = paths.spot[:, None] if kind == "asset" else 1.0
        return jnp.where(in_money, unit, 0.0)

    price_, se = price_path_payoff_mc(
        params, payoff, spot, maturity, key,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=(kind == "asset"),
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )
    if jnp.ndim(strikes) == 0:
        return price_[0], se[0]
    return price_, se


def price_touch_mc(
    params: HestonParams,
    barrier,
    maturity,
    spot,
    key,
    *,
    touch: bool = True,
    rate=0.0,
    dividend=0.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    sampler: str = "pseudo",
    n_replicates: int = 8,
    continuity_correction: bool = True,
    direction: str | None = None,
):
    """One-touch / no-touch cash digital paying 1 at EXPIRY, via QE MC.
    Returns (price, stderr).

    ``direction`` ("up"/"down") selects the barrier side STATICALLY, like
    :func:`price_barrier_mc`'s ``barrier_type`` — pass it whenever
    barrier/spot are traced (inside an outer jit/vmap), since the default
    ``None`` infers it from their concrete values (up if barrier above
    spot) and raises a clear error on tracers.  Default
    ``continuity_correction=True`` prices the *continuously* monitored
    contract by weighting each path with its Brownian-bridge no-touch
    probability (same machinery as :func:`price_barrier_mc`); ``False``
    gives the discretely monitored contract on the ``n_steps`` dates.
    Black-Scholes oracle: ``black_scholes.touch_price`` (matched in the
    small vol-of-vol limit in tests/test_digital.py).
    """
    if direction is None:
        if isinstance(barrier, jax.core.Tracer) or isinstance(
            spot, jax.core.Tracer
        ):
            raise ValueError(
                "price_touch_mc: barrier/spot are traced — the barrier side "
                "selects a code path, so pass direction='up' or 'down' "
                "explicitly (as with price_barrier_mc's barrier_type)"
            )
        direction = "up" if float(barrier) > float(spot) else "down"
    elif direction not in ("up", "down"):
        raise ValueError(f"direction must be 'up' or 'down', got {direction!r}")

    if continuity_correction:
        simulate_fn = functools.partial(
            simulate_qe, barrier=barrier, barrier_direction=direction
        )

        def payoff(paths: MCPaths):
            return 1.0 - paths.survival if touch else paths.survival

    else:
        simulate_fn = None

        def payoff(paths: MCPaths):
            if direction == "up":
                hit = paths.s_max >= barrier
            else:
                hit = paths.s_min <= barrier
            want = hit if touch else ~hit
            return jnp.where(want, 1.0, 0.0)

    return price_path_payoff_mc(
        params, payoff, spot, maturity, key,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=False,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )


def price_lookback_mc(
    params: HestonParams,
    maturity,
    spot,
    key,
    *,
    strike=None,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_fn=None,
    sampler: str = "pseudo",
    n_replicates: int = 8,
):
    """Lookback option on the discretely monitored extremum.

    ``strike=None`` prices the floating-strike contract
    (call: ``S_T - min S``; put: ``max S - S_T``); a fixed strike prices
    ``(max S - K)+`` / ``(K - min S)+``.  Returns (price, stderr).
    """

    def payoff(paths: MCPaths):
        if strike is None:
            if is_call:
                return paths.spot - paths.s_min
            return paths.s_max - paths.spot
        if is_call:
            return jnp.maximum(paths.s_max - strike, 0.0)
        return jnp.maximum(strike - paths.s_min, 0.0)

    return price_path_payoff_mc(
        params, payoff, spot, maturity, key,
        rate=rate, dividend=dividend, n_steps=n_steps, n_paths=n_paths,
        antithetic=antithetic, control_variate=False,
        simulate_fn=simulate_fn, sampler=sampler, n_replicates=n_replicates,
    )


def _fixing_indices(n_steps: int, maturity, times):
    """Map fixing times onto the stored-path row grid t_1 .. t_N.

    ``maturity`` and ``times`` must be static Python numbers: fixing dates
    are contract schedule, not traced data.  Raises if a fixing does not lie
    (to 1e-9 relative) on the simulation grid — silently snapping would bias
    the forward-vol exposure the contract is meant to isolate.
    """
    mat = float(maturity)
    idx = []
    for t in times:
        frac = float(t) / mat
        i = int(round(frac * n_steps))
        if i < 1 or i > n_steps or abs(i / n_steps - frac) > 1e-9:
            raise ValueError(
                f"fixing t={t} not on the n_steps={n_steps} grid of "
                f"maturity={mat}; choose n_steps a multiple of the fixing "
                "schedule"
            )
        idx.append(i - 1)  # stored rows are t_1..t_N
    return idx


def price_forward_start_mc(
    params: HestonParams,
    rel_strikes,
    fixing,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    notional=1.0,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_paths_fn=None,
):
    """Forward-start vanilla: pays ``notional * (S_T/S_{t0} - k)^+`` at T.

    The reference platform prices only spot-started vanillas
    (src/cpp/models/heston.cpp:94-151); forward-starts are the canonical
    forward-smile instrument (cliquet legs) and need either the
    forward characteristic function or a path simulation — here the QE
    engine, with ``fixing`` (= t0) snapped onto the time grid.

    Because the QE log-spot recursion's increments do not depend on the
    level, ``S_T/S_{t0}`` is exactly spot-homogeneous: the returned price is
    independent of ``spot`` (a property test pins this).  Returns
    ``(price, stderr)`` shaped like ``rel_strikes``.
    """
    dtype = result_dtype(spot, maturity, params.kappa)
    sim = simulate_paths_fn or simulate_qe_paths
    s_path, _ = sim(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths, rate=rate, dividend=dividend,
        antithetic=antithetic,
    )
    (i_fix,) = _fixing_indices(n_steps, maturity, [fixing])
    ratio = s_path[-1] / s_path[i_fix]  # (n_paths,)

    k = jnp.atleast_1d(jnp.asarray(rel_strikes, dtype))
    sign = jnp.broadcast_to(
        jnp.where(jnp.asarray(is_call), 1.0, -1.0), k.shape
    ).astype(dtype)
    disc = jnp.exp(-jnp.asarray(rate, dtype) * jnp.asarray(maturity, dtype))
    y = (
        jnp.asarray(notional, dtype)
        * disc
        * jnp.maximum(sign[None, :] * (ratio[:, None] - k[None, :]), 0.0)
    )
    price, stderr = _mc_estimate(y, n_paths, antithetic)
    if jnp.ndim(rel_strikes) == 0:
        return price[0], stderr[0]
    return price, stderr


def price_cliquet_mc(
    params: HestonParams,
    maturity,
    spot,
    key,
    *,
    n_periods: int = 12,
    local_floor=0.0,
    local_cap=0.08,
    global_floor=0.0,
    global_cap=None,
    notional=1.0,
    rate=0.0,
    dividend=0.0,
    n_steps: int | None = None,
    n_paths: int = 65536,
    antithetic: bool = True,
    simulate_paths_fn=None,
):
    """Cliquet (ratchet) note: capped/floored sum of period returns.

    Pays ``notional * clip(sum_j clip(S_j/S_{j-1} - 1, lf, lc), gf, gc)`` at
    maturity over ``n_periods`` equal fixing periods.  The local cap/floor
    make this a strip of forward-start call spreads — the classic
    forward-smile-sensitive exotic the reference's spot-started pricers
    (src/cpp/models/heston.cpp:94-151) cannot express.

    ``n_steps`` defaults to the smallest multiple of ``n_periods`` that is
    >= 64 so every fixing lies on the simulation grid.  Returns
    ``(price, stderr)`` scalars.
    """
    if n_steps is None:
        n_steps = max(64, n_periods)
        n_steps = ((n_steps + n_periods - 1) // n_periods) * n_periods
    if n_steps % n_periods:
        raise ValueError(
            f"n_steps={n_steps} must be a multiple of n_periods={n_periods}"
        )
    dtype = result_dtype(spot, maturity, params.kappa)
    sim = simulate_paths_fn or simulate_qe_paths
    s_path, _ = sim(
        params, spot, maturity, key,
        n_steps=n_steps, n_paths=n_paths, rate=rate, dividend=dividend,
        antithetic=antithetic,
    )
    spp = n_steps // n_periods
    fix = s_path[spp - 1 :: spp]  # (n_periods, n_paths) at t_1..t_P
    prev = jnp.concatenate(
        [jnp.full((1, n_paths), jnp.asarray(spot, dtype), dtype), fix[:-1]],
        axis=0,
    )
    rets = jnp.clip(
        fix / prev - 1.0,
        jnp.asarray(local_floor, dtype),
        jnp.asarray(local_cap, dtype),
    )
    total = jnp.sum(rets, axis=0)
    total = jnp.maximum(total, jnp.asarray(global_floor, dtype))
    if global_cap is not None:
        total = jnp.minimum(total, jnp.asarray(global_cap, dtype))
    disc = jnp.exp(-jnp.asarray(rate, dtype) * jnp.asarray(maturity, dtype))
    y = jnp.asarray(notional, dtype) * disc * total
    price, stderr = _mc_estimate(y[:, None], n_paths, antithetic)
    return price[0], stderr[0]


def greeks_european_mc(
    params: HestonParams,
    strikes,
    maturity,
    spot,
    key,
    *,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_steps: int = 64,
    n_paths: int = 65536,
    antithetic: bool = True,
    control_variate: bool = True,
):
    """Pathwise (AD) Greeks of the QE Monte Carlo European price.

    Forward-mode differentiation of the *whole simulation* — 7 tangents
    (spot, rate, and the five Heston parameters) ride one pass through the
    ``lax.scan``, so the marginal cost over pricing is ~7 elementwise
    streams, with none of the FD truncation error or 2x-per-greek repricing
    of the reference's bump-and-reprice (src/cpp/models/heston.cpp:169-218).

    Delta is an exact pathwise estimator (the payoff is Lipschitz in spot
    and the QE log-increments are level-independent).  Parameter greeks
    (``vega`` = dV/dv0, ``d_kappa``/``d_theta``/``d_sigma``/``d_rho``)
    differentiate through the QE branch *selection* but not the branch
    indicator itself, so they carry a small O(discretization) bias — the CF
    pricer's :func:`pde_tpu.models.heston.greeks_ad` is the exact check.
    Second-order greeks (gamma) are NOT valid pathwise on a kinked payoff;
    use ``greeks_ad``.

    Returns a dict of arrays shaped like ``strikes``:
    ``price, stderr, delta, rho, vega, d_kappa, d_theta, d_sigma, d_rho``.
    """
    strikes_a = jnp.atleast_1d(jnp.asarray(strikes))
    dtype = result_dtype(spot, maturity, params.kappa)
    p_cast = params._replace(
        **{f: jnp.asarray(getattr(params, f), dtype) for f in params._fields}
    )

    def price_fn(spot_, params_, rate_):
        p, _ = price_european_mc(
            params_, strikes_a, maturity, spot_, key,
            rate=rate_, dividend=dividend, is_call=is_call,
            n_steps=n_steps, n_paths=n_paths, antithetic=antithetic,
            control_variate=control_variate,
        )
        return jnp.atleast_1d(p)

    price, stderr = price_european_mc(
        p_cast, strikes_a, maturity, spot, key,
        rate=rate, dividend=dividend, is_call=is_call,
        n_steps=n_steps, n_paths=n_paths, antithetic=antithetic,
        control_variate=control_variate,
    )
    d_spot, d_params, d_rate = jax.jacfwd(price_fn, argnums=(0, 1, 2))(
        jnp.asarray(spot, dtype), p_cast, jnp.asarray(rate, dtype)
    )
    out = {
        "price": price,
        "stderr": stderr,
        "delta": d_spot,
        "rho": d_rate,
        "vega": d_params.v0,  # dV/dv0, matching greeks_ad's convention
        "d_kappa": d_params.kappa,
        "d_theta": d_params.theta,
        "d_sigma": d_params.sigma,
        "d_rho": d_params.rho,
    }
    if jnp.ndim(strikes) == 0:
        out = {k: v[0] if jnp.ndim(v) else v for k, v in out.items()}
    return out
