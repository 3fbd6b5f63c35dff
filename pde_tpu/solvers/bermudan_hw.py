"""Bermudan swaptions under Hull-White — PDE lattice + exact-transition
LSM/dual Monte Carlo, cross-validating each other.

Extends the rates family (models/rates.py) with the instrument that
actually needs a numerical early-exercise engine: the Bermudan swaption.
The reference framework has no early-exercise machinery beyond the vanilla
obstacle projection in its equity PDE solvers
(/root/reference/src/cpp/solvers/black_scholes_pde.hpp:116-124); it has no
rates models at all.

Two independent routes, both on device:

* **PDE** (:func:`bermudan_swaption_pde`).  In the decomposition
  ``r(t) = x(t) + alpha(t)`` the factor ``x`` is a plain OU process
  ``dx = -a x dt + sigma dW`` with CONSTANT coefficients, so the pricing
  PDE on the x-grid is

      V_t + (1/2) sigma^2 V_xx - a x V_x - (x + alpha(t)) V = 0,

  a constant-stencil Crank-Nicolson march whose only time dependence is
  the scalar ``alpha(t)`` on the reaction term.  Exercise dates project
  onto the closed-form remaining-swap value (the same affine bond
  reconstruction as models/rates.hw_bond).  Boundary rows drop the
  diffusion and upwind the (strongly mean-reverting) convection, keeping
  the system tridiagonal; two implicit Rannacher steps after every
  projection damp the kink.  One ``lax.scan`` marches the whole date
  structure — per-step dt/alpha/weight arrays, per-step intrinsic rows
  only where a date actually exercises (static shapes, no Python control
  flow in the hot loop).

* **Monte Carlo** (:func:`bermudan_swaption_mc`).  The pair
  ``(x(t), int_0^t x ds)`` is JOINTLY Gaussian with closed-form moments,
  so paths step directly from exercise date to exercise date with ZERO
  discretization bias — the deterministic part of the money-market
  account is the closed-form ``int alpha`` (which reproduces the curve
  exactly: ``E[e^{-int r}] = P(0,T)`` holds in exact arithmetic, pinned
  in tests).  Longstaff-Schwartz regression on an x-polynomial basis
  gives the frozen policy; an out-of-sample re-simulation gives the
  genuine lower bound; nested exact sub-simulations give the
  Andersen-Broadie dual upper bound (same duality argument as
  solvers/lsm_dual.py, but here the inner paths are exact too).

Validation: with a single exercise date both routes collapse to the
European swaption and must match the Jamshidian closed form
(models/rates.hw_swaption); with the full schedule the PDE price must sit
inside (or within tolerance of) the MC sandwich, and above the best
European.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype
from ..models import rates
from ..models.rates import HullWhiteParams
from ..ops.tridiag import thomas

__all__ = [
    "remaining_swap_value",
    "bermudan_swaption_pde",
    "bermudan_swaption_mc",
    "hw_joint_increment_moments",
    "hw_alpha_integral",
]


# ---------------------------------------------------------------------------
# closed-form building blocks


def hw_alpha_integral(params: HullWhiteParams, t1, t2):
    """``int_{t1}^{t2} alpha(s) ds`` in closed form.

    ``alpha(t) = f(0,t) + sigma^2/(2a^2) (1 - e^{-at})^2``; the forward
    part integrates to ``log(P(0,t1)/P(0,t2))`` and the variance part is
    elementary.  Broadcasts over ``t1``/``t2``.
    """
    a, sig, curve = params.a, params.sigma, params.curve
    t1 = jnp.asarray(t1)
    t2 = jnp.asarray(t2)
    fwd_part = jnp.log(curve.df(t1) / curve.df(t2))
    e1, e2 = jnp.exp(-a * t1), jnp.exp(-a * t2)
    var_part = (sig * sig / (2.0 * a * a)) * (
        (t2 - t1)
        + (2.0 / a) * (e2 - e1)
        - (1.0 / (2.0 * a)) * (e2 * e2 - e1 * e1)
    )
    return fwd_part + var_part


def hw_joint_increment_moments(params: HullWhiteParams, dt):
    """Moments of the exact joint OU increment over a step of length ``dt``.

    For ``x' = x(t+dt)`` and ``y = int_t^{t+dt} x(s) ds`` given ``x(t) = x``:

        x' | x  ~  N(x e^{-a dt},            v_x)
        y  | x  ~  N(x B(dt),                v_y),   Cov(x', y) = c

    with ``B(dt) = (1 - e^{-a dt})/a``.  Returns
    ``(e, B, v_x, v_y, c)``; sampling uses the Cholesky split
    ``eps_y = (c/sqrt(v_x)) z1 + sqrt(v_y - c^2/v_x) z2``.
    """
    a, sig = params.a, params.sigma
    dt = jnp.asarray(dt)
    e = jnp.exp(-a * dt)
    e2 = e * e
    B = (1.0 - e) / a
    v_x = sig * sig * (1.0 - e2) / (2.0 * a)
    c = (sig * sig / a) * (B - (1.0 - e2) / (2.0 * a))
    v_y = (sig * sig / (a * a)) * (dt - 2.0 * B + (1.0 - e2) / (2.0 * a))
    return e, B, v_x, v_y, c


def remaining_swap_value(
    params: HullWhiteParams, strike_rate, schedule, j, x, payer=True
):
    """Value at schedule date ``T_j`` (short rate ``r = x + alpha(T_j)``) of
    entering the REMAINING swap: fixed leg pays ``tau_i * K`` at
    ``T_{j+1}..T_M``, float leg is worth par.  ``j`` is a static int;
    broadcasts over ``x``.

    payer = 1 - sum_i c_i P(T_j, T_i),  c_i = tau_i K (+1 at T_M).
    """
    schedule = jnp.asarray(schedule)
    taus = jnp.diff(schedule)
    pay = schedule[j + 1:]
    coupons = taus[j:] * jnp.asarray(strike_rate)
    coupons = coupons.at[-1].add(1.0)
    t_j = schedule[j]
    r = jnp.asarray(x)[..., None] + _alpha_at(params, t_j)
    bonds = rates.hw_bond(params, pay, t_j, r)          # (..., M-j)
    bond_val = jnp.sum(coupons * bonds, axis=-1)
    val = 1.0 - bond_val
    return val if payer else -val


def _alpha_at(params: HullWhiteParams, t):
    return rates.hw_alpha(params, t)


# ---------------------------------------------------------------------------
# PDE route


def _march_plan(schedule, exercise, n_sub, dtype):
    """Static backward-march plan over the event structure (host side —
    the schedule must be concrete, which it always is for a real trade).

    The option dies after its LAST exercisable date T_last, so the march
    starts there with ``V = max(swap, 0)`` and walks down to 0 through each
    earlier event.  Returns per-step arrays in backward-march order: dt,
    t_mid (where alpha is sampled), the theta-scheme weight (two implicit
    Rannacher steps after every projection), and for each step the index
    of the event whose projection applies AFTER it (-1 = none).
    """
    import numpy as np

    sched = np.asarray(schedule, float)
    last = max(j for j, b in enumerate(exercise) if b)
    dts, mids, ws, ev_after = [], [], [], []
    t_hi = sched[last]
    for j in range(last - 1, -2, -1):
        t_lo = sched[j] if j >= 0 else 0.0
        dt = (t_hi - t_lo) / n_sub
        for k in range(n_sub):
            a, b = t_hi - k * dt, t_hi - (k + 1) * dt
            dts.append(dt)
            mids.append(0.5 * (a + b))
            ws.append(1.0 if k < 2 else 0.5)
            ev_after.append(j if (k == n_sub - 1 and j >= 0) else -1)
        t_hi = t_lo
    return (
        jnp.asarray(dts, dtype),
        jnp.asarray(mids, dtype),
        jnp.asarray(ws, dtype),
        jnp.asarray(ev_after, jnp.int32),
        last,
    )


@functools.partial(
    jax.jit,
    static_argnames=("payer", "n_x", "last", "exercise"),
)
def _bermudan_pde_impl(
    params, strike_rate, schedule, dts, mids, ws, ev_after, *,
    payer, n_x, last, exercise,
):
    dtype = schedule.dtype
    a, sig = params.a, params.sigma
    T_last_ex = schedule[last]

    # x-grid: symmetric, includes 0; width covers the OU law at the last
    # exercise date (stationary-capped) with a wide safety factor
    sd = sig * jnp.sqrt((1.0 - jnp.exp(-2.0 * a * T_last_ex)) / (2.0 * a))
    x_max = 8.0 * jnp.maximum(sd, 1e-4)
    x = jnp.linspace(-x_max, x_max, n_x, dtype=dtype)
    dx = x[1] - x[0]

    alphas = _alpha_at(params, mids)

    # intrinsic at every candidate date (rows j = 0..last); non-exercise
    # dates get -inf so the masked projection is a no-op there
    def intrinsic_row(j):
        v = remaining_swap_value(params, strike_rate, schedule, j, x, payer)
        v = jnp.maximum(v, 0.0)
        return v if exercise[j] else jnp.full_like(v, -jnp.inf)

    intr = jnp.stack([intrinsic_row(j) for j in range(last + 1)])  # (M, n_x)

    # constant-stencil interior operator, split into the x-independent
    # diffusion part and the x-linear convection/reaction parts
    diff = 0.5 * sig * sig / (dx * dx)
    conv = -a * x / (2.0 * dx)                    # convection coeff on +/- 1
    lo_row = diff - conv                          # L[i, i-1]
    up_row = diff + conv                          # L[i, i+1]
    di_row = -2.0 * diff - x                      # L[i, i] minus alpha(t)
    # boundary rows: drop diffusion, upwind the convection (the drift -a x
    # always points INWARD at the boundary, so upwinding reads the interior
    # neighbor and the tridiagonal structure survives)
    lo_row = lo_row.at[0].set(0.0).at[-1].set(a * x[-1] / dx)
    up_row = up_row.at[0].set(-a * x[0] / dx).at[-1].set(0.0)
    di_row = di_row.at[0].set(a * x[0] / dx - x[0])
    di_row = di_row.at[-1].set(-a * x[-1] / dx - x[-1])

    def apply_L(V, alpha):
        Vm = jnp.concatenate([jnp.zeros((1,), dtype), V[:-1]])
        Vp = jnp.concatenate([V[1:], jnp.zeros((1,), dtype)])
        return lo_row * Vm + (di_row - alpha) * V + up_row * Vp

    v0 = jnp.maximum(
        remaining_swap_value(params, strike_rate, schedule, last, x, payer),
        0.0,
    )

    def step(V, inp):
        dt, alpha, w, intr_row = inp
        rhs = V + (1.0 - w) * dt * apply_L(V, alpha)
        lo = -w * dt * lo_row[1:]
        di = 1.0 - w * dt * (di_row - alpha)
        up = -w * dt * up_row[:-1]
        V_new = thomas(lo, di, up, rhs)
        V_new = jnp.maximum(V_new, intr_row)      # -inf rows: no-op
        return V_new, None

    # gather per-step intrinsic rows (−inf where no event follows the step)
    dead = jnp.full((1, n_x), -jnp.inf, dtype)
    intr_steps = jnp.concatenate([intr, dead])[ev_after]  # (n_t, n_x)

    V, _ = jax.lax.scan(step, v0, (dts, alphas, ws, intr_steps))
    i0 = (n_x - 1) // 2                           # x = 0 exactly (n_x odd)
    return V[i0], x, V


def bermudan_swaption_pde(
    params: HullWhiteParams,
    strike_rate,
    schedule,
    *,
    payer: bool = True,
    exercise: Tuple[bool, ...] | None = None,
    n_x: int = 401,
    n_sub: int = 24,
):
    """Bermudan payer/receiver swaption on the swap with date ``schedule``
    (T_0..T_M; fixed leg pays at T_1..T_M), exercisable into the remaining
    swap at each ``schedule[j]`` with ``exercise[j]`` true (default: all of
    T_0..T_{M-1}).

    Returns ``(price, x_grid, value_on_grid)`` — the price is the t=0 value
    at ``x = 0`` (``r_0 = f(0,0)``).
    """
    schedule = jnp.asarray(schedule)
    dtype = result_dtype(schedule, params.sigma)
    schedule = schedule.astype(dtype)
    m = int(schedule.shape[0]) - 1
    if exercise is None:
        exercise = (True,) * m
    exercise = tuple(bool(b) for b in exercise)
    if len(exercise) != m or not any(exercise):
        raise ValueError("exercise must flag at least one of the M dates")
    if n_x % 2 == 0:
        raise ValueError("n_x must be odd so x = 0 is on the grid")
    dts, mids, ws, ev_after, last = _march_plan(
        schedule, exercise, n_sub, dtype)
    price, x, V = _bermudan_pde_impl(
        params, jnp.asarray(strike_rate, dtype), schedule,
        dts, mids, ws, ev_after,
        payer=payer, n_x=n_x, last=last, exercise=exercise)
    return price, x, V


# ---------------------------------------------------------------------------
# Monte Carlo route: exact transitions + LSM + Andersen-Broadie dual


def _mc_basis(x):
    """Polynomial regression basis in the single Gaussian factor."""
    return jnp.stack([jnp.ones_like(x), x, x * x, x * x * x], axis=-1)


def _simulate_events(params, schedule, exercise_idx, n_paths, key, dtype):
    """Exact path panel at the exercise dates.

    Returns ``(xs, log_ds)`` of shape (n_ex, n_paths): the factor and the
    cumulative LOG stochastic+deterministic discount ``-int_0^{T_j} r ds``
    at each exercise date, both exact in distribution.
    """
    ts = jnp.concatenate([jnp.zeros((1,), dtype), schedule[exercise_idx]])
    dts = jnp.diff(ts)
    e, B, v_x, v_y, c = hw_joint_increment_moments(params, dts)
    # deterministic -int alpha per step
    da = hw_alpha_integral(params, ts[:-1], ts[1:])
    sd_x = jnp.sqrt(v_x)
    c_over = c / jnp.maximum(sd_x, 1e-30)
    sd_y = jnp.sqrt(jnp.maximum(v_y - c_over * c_over, 0.0))

    def step(carry, inp):
        xv, logd = carry
        e_t, B_t, sx, co, sy, da_t, k_t = inp
        z = jax.random.normal(k_t, (2,) + xv.shape, dtype)
        x_new = xv * e_t + sx * z[0]
        y = xv * B_t + co * z[0] + sy * z[1]
        logd = logd - da_t - y
        return (x_new, logd), (x_new, logd)

    keys = jax.random.split(key, dts.shape[0])
    init = (jnp.zeros((n_paths,), dtype), jnp.zeros((n_paths,), dtype))
    _, (xs, log_ds) = jax.lax.scan(
        step, init, (e, B, sd_x, c_over, sd_y, da, keys))
    return xs, log_ds


@functools.partial(
    jax.jit,
    static_argnames=(
        "payer", "exercise", "n_schedule",
        "n_paths", "n_outer", "n_inner",
    ),
)
def _bermudan_mc_impl(
    params, strike_rate, schedule, key, *,
    payer, exercise, n_schedule, n_paths, n_outer, n_inner,
):
    dtype = schedule.dtype
    ex_idx = tuple(j for j, b in enumerate(exercise) if b)
    n_ex = len(ex_idx)
    ex_arr = jnp.asarray(ex_idx)

    def payoff_at(row, x):
        """Discount-free exercise value at exercise row ``row`` (static)."""
        return jnp.maximum(
            remaining_swap_value(
                params, strike_rate, schedule, ex_idx[row], x, payer),
            0.0,
        )

    k_reg, k_out, k_in = jax.random.split(key, 3)

    # -- phase 1: regression pass -> frozen policy -----------------------
    # Cashflows live in time-0 discounted units; the regression at date
    # T_j divides each path's cashflow by ITS OWN discount D_j, so the
    # regressand is the future cashflow discounted T_j -> tau only.  Its
    # conditional mean given x_j is exactly the continuation value C_j(x)
    # (x is Markov), so the policy is a pure STATE rule — no path-dependent
    # discount leaks into the decision (that would bias it: D_j varies
    # given x_j).
    xs, log_ds = _simulate_events(params, schedule, ex_arr, n_paths, k_reg,
                                  dtype)
    ds = jnp.exp(log_ds)                          # (n_ex, P) discounts to 0
    pay = jnp.stack([payoff_at(j, xs[j]) for j in range(n_ex)])

    cash = ds[-1] * pay[-1]
    gammas = []
    for j in range(n_ex - 2, -1, -1):
        phi = _mc_basis(xs[j])
        w = (pay[j] > 0.0).astype(dtype)
        gram = (phi * w[:, None]).T @ phi + 1e-10 * jnp.eye(
            phi.shape[-1], dtype=dtype)
        rhs = (phi * w[:, None]).T @ (cash / ds[j])
        beta = jnp.linalg.solve(gram, rhs)
        cont = phi @ beta                          # C_j estimate, T_j units
        ex = (pay[j] > 0.0) & (pay[j] > cont)
        cash = jnp.where(ex, ds[j] * pay[j], cash)
        gammas.append(beta)
    gammas = jnp.stack(gammas[::-1] + [jnp.zeros((_mc_basis(
        jnp.zeros((1,), dtype)).shape[-1],), dtype)])

    def policy_stops(row_idx, x):
        """Frozen state-only exercise rule at exercise row ``row_idx``
        (static): payoff vs fitted continuation, both in T_row units."""
        if row_idx == n_ex - 1:
            return jnp.ones(jnp.shape(x), bool)
        hv = payoff_at(row_idx, x)
        cont = _mc_basis(x) @ gammas[row_idx]
        return (hv > 0.0) & (hv > cont)

    # -- helper: continue from (x, log_d) at exercise row `start` ----------
    def continuation(start, x0, log_d0, k_t):
        """Mean discounted-to-0 payoff of CONTINUING the frozen policy from
        exercise row ``start`` (static; -1 = time 0)."""
        ts = jnp.concatenate([jnp.zeros((1,), dtype), schedule[ex_arr]])
        val = jnp.zeros(x0.shape, dtype)
        active = jnp.ones(x0.shape, bool)
        xv, logd = x0, log_d0
        for row in range(start + 1, n_ex):
            t_a = ts[row]                         # previous event (row-1+1)
            t_b = ts[row + 1]
            e, B, v_x, v_y, c = hw_joint_increment_moments(params, t_b - t_a)
            da = hw_alpha_integral(params, t_a, t_b)
            sd_x = jnp.sqrt(v_x)
            co = c / jnp.maximum(sd_x, 1e-30)
            sy = jnp.sqrt(jnp.maximum(v_y - co * co, 0.0))
            k_t, k_u = jax.random.split(k_t)
            z = jax.random.normal(k_u, (2,) + xv.shape, dtype)
            x_new = xv * e + sd_x * z[0]
            y = xv * B + co * z[0] + sy * z[1]
            logd = logd - da - y
            stop = active & policy_stops(row, x_new)
            val = val + jnp.where(
                stop, jnp.exp(logd) * payoff_at(row, x_new), 0.0)
            active = active & ~stop
            xv = x_new
        return val

    # -- phase 2: out-of-sample lower bound ------------------------------
    n0 = n_outer * n_inner
    k0, k_in = jax.random.split(k_in)
    val0 = continuation(
        -1, jnp.zeros((n0,), dtype), jnp.zeros((n0,), dtype), k0)
    lower = jnp.mean(val0)
    se_lower = jnp.std(val0) / jnp.sqrt(1.0 * n0)

    # -- phase 3: Andersen-Broadie dual ----------------------------------
    xs_o, logd_o = _simulate_events(params, schedule, ex_arr, n_outer, k_out,
                                    dtype)
    d_o = jnp.exp(logd_o)
    h_o = jnp.stack([payoff_at(j, xs_o[j]) for j in range(n_ex)]) * d_o

    m = jnp.zeros((n_outer,), dtype)
    g_max = jnp.full((n_outer,), -jnp.inf, dtype)
    c_prev = lower                                 # scalar C_0 (same bundle)
    for row in range(n_ex):
        if row < n_ex - 1:
            k_row, k_in = jax.random.split(k_in)
            x_rep = jnp.repeat(xs_o[row], n_inner)
            d_rep = jnp.repeat(logd_o[row], n_inner)
            c_here = jnp.mean(
                continuation(row, x_rep, d_rep, k_row)
                .reshape(n_outer, n_inner), axis=1)
            stops = policy_stops(row, xs_o[row])
            v_hat = jnp.where(stops, h_o[row], c_here)
        else:
            v_hat = h_o[row]
            c_here = jnp.zeros_like(v_hat)
        m = m + (v_hat - c_prev)
        g_max = jnp.maximum(g_max, h_o[row] - m)
        c_prev = c_here
    upper = jnp.mean(jnp.maximum(g_max, 0.0))
    se_upper = jnp.std(jnp.maximum(g_max, 0.0)) / jnp.sqrt(1.0 * n_outer)
    return lower, se_lower, upper, se_upper


def bermudan_swaption_mc(
    params: HullWhiteParams,
    strike_rate,
    schedule,
    key,
    *,
    payer: bool = True,
    exercise: Tuple[bool, ...] | None = None,
    n_paths: int = 65536,
    n_outer: int = 512,
    n_inner: int = 64,
):
    """LSM lower bound + Andersen-Broadie dual upper bound for the Bermudan
    swaption — exact-transition paths (zero discretization bias).

    Returns ``(lower, se_lower, upper, se_upper)``; see the module
    docstring for the sandwich guarantee.
    """
    schedule = jnp.asarray(schedule)
    dtype = result_dtype(schedule, params.sigma)
    schedule = schedule.astype(dtype)
    m = int(schedule.shape[0]) - 1
    if exercise is None:
        exercise = (True,) * m
    exercise = tuple(bool(b) for b in exercise)
    if len(exercise) != m or not any(exercise):
        raise ValueError("exercise must flag at least one of the M dates")
    return _bermudan_mc_impl(
        params, jnp.asarray(strike_rate, dtype), schedule, key,
        payer=payer, exercise=exercise, n_schedule=m + 1,
        n_paths=n_paths, n_outer=n_outer, n_inner=n_inner)
