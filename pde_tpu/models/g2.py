"""G2++ two-factor Gaussian short-rate model.

``r(t) = x(t) + y(t) + phi(t)`` with two correlated constant-coefficient
OU factors

    dx = -a x dt + sigma dW1,   dy = -b y dt + eta dW2,
    d<W1, W2> = rho dt,         x(0) = y(0) = 0,

and ``phi`` fitted so the model reproduces the input discount curve
exactly (same embedding as models/rates.HullWhiteParams; Brigo-Mercurio
ch. 4 is the standard source for every closed form below).  G2++ is the
minimal model with non-trivial forward-rate DEcorrelation — the one-factor
Hull-White moves all forwards in lockstep, so instruments sensitive to
curve twist (Bermudans with long tails, CMS spreads) need the second
factor.

New family beyond the reference (equity-only models,
/root/reference/src/cpp/models/); everything here is closed-form affine
algebra + one Gauss-Hermite contraction, built to broadcast and to be
jit/vmap/grad-safe:

* bonds, ZCB options (lognormal Black kernel shared with Hull-White),
  caplets/caps by static replication;
* European swaptions by the Brigo-Mercurio one-dimensional reduction:
  Gauss-Hermite nodes over the first factor under the T0-forward measure,
  a fixed-trip-count vectorized Newton for the critical boundary
  ``ybar(x)``, then one fused expression per node — no scalar loops, no
  data-dependent control flow;
* exact joint increment moments for ``(x, y, int (x+y))`` so Monte Carlo
  (and the Bermudan LSM in solvers/bermudan_g2.py) steps date-to-date
  with zero discretization bias; the martingale identity
  ``E[e^{-int r}] = P(0,T)`` holds in exact arithmetic.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import result_dtype
from ..utils.stats import norm_cdf as _norm_cdf
from .rates import DiscountCurve, _affine_b, _zcb_option_black

__all__ = [
    "G2Params",
    "g2_bond",
    "g2_zcb_option",
    "g2_caplet",
    "g2_cap",
    "g2_swaption",
    "g2_joint_increment_moments",
    "g2_phi_integral",
    "g2_simulate",
]


class G2Params(NamedTuple):
    """G2++ parameters with the market curve embedded (phi is implicit —
    every pricer works off ``curve`` directly, so the curve is reproduced
    exactly and calibration only fits the five dynamical parameters)."""

    a: jnp.ndarray
    b: jnp.ndarray
    sigma: jnp.ndarray
    eta: jnp.ndarray
    rho: jnp.ndarray
    curve: DiscountCurve

    def validate(self):
        for name in ("a", "b", "sigma", "eta"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(f"{name} must be positive")
        if not -1.0 < float(self.rho) < 1.0:
            raise ValueError("rho must be in (-1, 1)")
        return self


def _v_func(p: G2Params, tau):
    """V(t, t+tau): the integrated bond-volatility variance (B-M 4.10)."""
    a, b, sig, eta, rho = p.a, p.b, p.sigma, p.eta, p.rho
    ea, eb = jnp.exp(-a * tau), jnp.exp(-b * tau)
    v1 = (sig * sig / (a * a)) * (
        tau + (2.0 / a) * ea - (1.0 / (2.0 * a)) * ea * ea - 3.0 / (2.0 * a)
    )
    v2 = (eta * eta / (b * b)) * (
        tau + (2.0 / b) * eb - (1.0 / (2.0 * b)) * eb * eb - 3.0 / (2.0 * b)
    )
    v12 = (2.0 * rho * sig * eta / (a * b)) * (
        tau + (ea - 1.0) / a + (eb - 1.0) / b
        - (jnp.exp(-(a + b) * tau) - 1.0) / (a + b)
    )
    return v1 + v2 + v12


def g2_bond(params: G2Params, maturity, t=0.0, x=None, y=None):
    """P(t, T | x, y).  At ``t = 0`` (factors None) returns ``curve.df(T)``
    exactly."""
    curve = params.curve
    if x is None and y is None:
        return curve.df(maturity)
    t = jnp.asarray(t)
    T = jnp.asarray(maturity)
    tau = T - t
    lnA = (
        jnp.log(curve.df(T) / curve.df(t))
        + 0.5 * (_v_func(params, tau) - _v_func(params, T)
                 + _v_func(params, t))
    )
    Ba = _affine_b(params.a, tau)
    Bb = _affine_b(params.b, tau)
    return jnp.exp(lnA - Ba * x - Bb * y)


def _sigma_p(params: G2Params, expiry, bond_maturity):
    """Lognormal stdev of P(T0, T1) seen from 0 (B-M 4.15)."""
    a, b, sig, eta, rho = (
        params.a, params.b, params.sigma, params.eta, params.rho)
    T0 = jnp.asarray(expiry)
    du = jnp.asarray(bond_maturity) - T0
    s2 = (
        sig * sig / (2.0 * a**3)
        * (1.0 - jnp.exp(-a * du)) ** 2 * (1.0 - jnp.exp(-2.0 * a * T0))
        + eta * eta / (2.0 * b**3)
        * (1.0 - jnp.exp(-b * du)) ** 2 * (1.0 - jnp.exp(-2.0 * b * T0))
        + 2.0 * rho * sig * eta / (a * b * (a + b))
        * (1.0 - jnp.exp(-a * du)) * (1.0 - jnp.exp(-b * du))
        * (1.0 - jnp.exp(-(a + b) * T0))
    )
    return jnp.sqrt(s2)


def g2_zcb_option(params: G2Params, strike, expiry, bond_maturity,
                  is_call=True):
    """European option on a ZCB — lognormal Black kernel (shared with
    Hull-White: models/rates._zcb_option_black)."""
    curve = params.curve
    return _zcb_option_black(
        curve.df(expiry), curve.df(bond_maturity), strike,
        _sigma_p(params, expiry, bond_maturity), is_call)


def g2_caplet(params: G2Params, strike_rate, start, end, notional=1.0):
    """Caplet by the standard ZCB-put static replication."""
    tau = jnp.asarray(end) - jnp.asarray(start)
    kb = 1.0 / (1.0 + tau * jnp.asarray(strike_rate))
    put = g2_zcb_option(params, kb, start, end, is_call=False)
    return notional * (1.0 + tau * strike_rate) * put


def g2_cap(params: G2Params, strike_rate, pay_times, notional=1.0):
    pt = jnp.asarray(pay_times)
    return jnp.sum(
        g2_caplet(params, strike_rate, pt[:-1], pt[1:], notional), axis=-1)


# ---------------------------------------------------------------------------
# European swaption: the Brigo-Mercurio 1D reduction


def _forward_measure_moments(params: G2Params, T0):
    """Mean/stdev/correlation of (x(T0), y(T0)) under the T0-forward
    measure (B-M 4.29-4.30): the drift correction -M^T(0,T0) per factor."""
    a, b, sig, eta, rho = (
        params.a, params.b, params.sigma, params.eta, params.rho)
    ea, eb = jnp.exp(-a * T0), jnp.exp(-b * T0)
    eab = jnp.exp(-(a + b) * T0)
    mx = -(
        (sig * sig / (a * a) + rho * sig * eta / (a * b)) * (1.0 - ea)
        - sig * sig / (2.0 * a * a) * (1.0 - ea * ea)
        - rho * sig * eta / (b * (a + b)) * (1.0 - eab)
    )
    my = -(
        (eta * eta / (b * b) + rho * sig * eta / (a * b)) * (1.0 - eb)
        - eta * eta / (2.0 * b * b) * (1.0 - eb * eb)
        - rho * sig * eta / (a * (a + b)) * (1.0 - eab)
    )
    sx = sig * jnp.sqrt((1.0 - ea * ea) / (2.0 * a))
    sy = eta * jnp.sqrt((1.0 - eb * eb) / (2.0 * b))
    rxy = rho * sig * eta * (1.0 - eab) / ((a + b) * sx * sy)
    return mx, my, sx, sy, rxy


@functools.partial(jax.jit, static_argnames=("payer", "n_gh", "n_newton"))
def _g2_swaption_impl(params, strike_rate, expiry, pay_times, *,
                      payer, n_gh, n_newton):
    dtype = pay_times.dtype
    curve = params.curve
    T0 = expiry
    taus = jnp.diff(jnp.concatenate([T0[None], pay_times]))
    c = taus * strike_rate
    c = c.at[-1].add(1.0)

    du = pay_times - T0
    Ba = _affine_b(params.a, du)
    Bb = _affine_b(params.b, du)
    lnA = (
        jnp.log(curve.df(pay_times) / curve.df(T0))
        + 0.5 * (_v_func(params, du) - _v_func(params, pay_times)
                 + _v_func(params, T0))
    )

    mx, my, sx, sy, rxy = _forward_measure_moments(params, T0)
    rbar = jnp.sqrt(1.0 - rxy * rxy)

    # Gauss-Hermite over x ~ N(mx, sx) under Q^{T0}
    gh_x, gh_w = np.polynomial.hermite_e.hermegauss(n_gh)
    xs = mx + sx * jnp.asarray(gh_x, dtype)          # (n_gh,)
    ws = jnp.asarray(gh_w / np.sqrt(2.0 * np.pi), dtype)

    # critical boundary ybar(x): sum_i c_i A_i e^{-Ba_i x - Bb_i y} = 1,
    # strictly decreasing in y -> fixed-trip Newton from y = my
    def f_and_df(yv, xv):
        e = c * jnp.exp(lnA - Ba * xv[:, None] - Bb * yv[:, None])
        return jnp.sum(e, axis=-1) - 1.0, -jnp.sum(Bb * e, axis=-1)

    def newton(yv, _):
        fv, dfv = f_and_df(yv, xs)
        return yv - fv / dfv, None

    ybar, _ = jax.lax.scan(
        newton, jnp.full(xs.shape, my, dtype), None, length=n_newton)

    # Payer exercises iff y > ybar(x) (bond leg cheap), receiver iff
    # y < ybar; conditioning y | x ~ N(mu_c, (sy rbar)^2) gives, per GH
    # node, Phi terms for the indicator and a completed-square exponential
    # for each e^{-Bb y} leg.  omega = +1 payer / -1 receiver.
    omega = 1.0 if payer else -1.0
    h1 = (ybar - my) / (sy * rbar) - rxy * (xs - mx) / (sx * rbar)
    h2 = h1[:, None] + Bb * sy * rbar
    lam = c * jnp.exp(lnA - Ba * xs[:, None])
    kap = -Bb * (
        my - 0.5 * rbar * rbar * sy * sy * Bb
        + rxy * sy * (xs[:, None] - mx) / sx
    )
    inner = _norm_cdf(-omega * h1) - jnp.sum(
        lam * jnp.exp(kap) * _norm_cdf(-omega * h2), axis=-1)
    return omega * curve.df(T0) * jnp.sum(ws * inner)


def g2_swaption(
    params: G2Params, strike_rate, expiry, pay_times, *,
    notional=1.0, payer: bool = True, n_gh: int = 64, n_newton: int = 20,
):
    """European payer/receiver swaption (B-M formula 4.31): one
    Gauss-Hermite contraction over the first factor, the critical boundary
    solved by a node-vectorized fixed-trip Newton."""
    pay_times = jnp.asarray(pay_times)
    dtype = result_dtype(pay_times, params.sigma)
    price = _g2_swaption_impl(
        params, jnp.asarray(strike_rate, dtype), jnp.asarray(expiry, dtype),
        pay_times.astype(dtype), payer=payer, n_gh=n_gh, n_newton=n_newton)
    return notional * price


# ---------------------------------------------------------------------------
# exact simulation: joint law of (x, y, int (x+y))


def g2_phi_integral(params: G2Params, t1, t2):
    """``int_{t1}^{t2} phi(s) ds`` in closed form.

    ``phi(t) = f(0,t) + sigma^2 Ba(t)^2/2 + eta^2 Bb(t)^2/2
    + rho sigma eta Ba(t) Bb(t)`` (B-M 4.12); each term integrates in
    elementary exponentials.
    """
    a, b, sig, eta, rho, curve = (
        params.a, params.b, params.sigma, params.eta, params.rho,
        params.curve)
    t1 = jnp.asarray(t1)
    t2 = jnp.asarray(t2)
    fwd = jnp.log(curve.df(t1) / curve.df(t2))

    def int_sq(z, t):
        # int_0^t (1 - e^{-z s})^2 ds
        return t + (2.0 / z) * (jnp.exp(-z * t) - 1.0) \
            - (1.0 / (2.0 * z)) * (jnp.exp(-2.0 * z * t) - 1.0)

    def int_cross(t):
        # int_0^t (1 - e^{-a s})(1 - e^{-b s}) ds
        return (
            t + (jnp.exp(-a * t) - 1.0) / a + (jnp.exp(-b * t) - 1.0) / b
            - (jnp.exp(-(a + b) * t) - 1.0) / (a + b)
        )

    quad = (
        0.5 * sig * sig / (a * a) * (int_sq(a, t2) - int_sq(a, t1))
        + 0.5 * eta * eta / (b * b) * (int_sq(b, t2) - int_sq(b, t1))
        + rho * sig * eta / (a * b) * (int_cross(t2) - int_cross(t1))
    )
    return fwd + quad


def g2_joint_increment_moments(params: G2Params, dt):
    """Exact moments of ``(x', y', S)`` over a step of length ``dt`` given
    ``(x, y)``, where ``S = int (x+y) ds`` over the step.

    Returns ``(means, cov)``: ``means = (ex, ey, Ba, Bb)`` such that

        E[x'] = x ex,  E[y'] = y ey,  E[S] = x Ba + y Bb,

    and ``cov`` the 3x3 covariance of ``(x', y', S)`` (state-independent).
    All entries are elementary exponentials (the same one-factor moments
    as solvers/bermudan_hw.hw_joint_increment_moments, plus the rho cross
    terms).
    """
    a, b, sig, eta, rho = (
        params.a, params.b, params.sigma, params.eta, params.rho)
    dt = jnp.asarray(dt)

    def one(z, s):
        e = jnp.exp(-z * dt)
        B = (1.0 - e) / z
        v_x = s * s * (1.0 - e * e) / (2.0 * z)
        c_xI = (s * s / z) * (B - (1.0 - e * e) / (2.0 * z))
        v_I = (s * s / (z * z)) * (
            dt - 2.0 * B + (1.0 - e * e) / (2.0 * z))
        return e, B, v_x, c_xI, v_I

    ea, Ba, vxa, cxa, vIa = one(a, sig)
    eb, Bb, vxb, cxb, vIb = one(b, eta)

    ab = a + b
    eab = jnp.exp(-ab * dt)
    # cross-factor second moments (driven by rho)
    c_xy = rho * sig * eta * (1.0 - eab) / ab                  # Cov(x', y')
    # Cov(x', I_b) = rho sig eta int e^{-a tau} Bb(tau) dtau
    c_x_Ib = rho * sig * eta / b * (
        (1.0 - jnp.exp(-a * dt)) / a - (1.0 - eab) / ab)
    c_y_Ia = rho * sig * eta / a * (
        (1.0 - jnp.exp(-b * dt)) / b - (1.0 - eab) / ab)
    # Cov(I_a, I_b) = rho sig eta int Ba(tau) Bb(tau) dtau
    c_IaIb = rho * sig * eta / (a * b) * (
        dt - (1.0 - jnp.exp(-a * dt)) / a - (1.0 - jnp.exp(-b * dt)) / b
        + (1.0 - eab) / ab)

    v_S = vIa + vIb + 2.0 * c_IaIb
    c_xS = cxa + c_x_Ib
    c_yS = cxb + c_y_Ia
    cov = jnp.stack([
        jnp.stack([vxa, c_xy, c_xS]),
        jnp.stack([c_xy, vxb, c_yS]),
        jnp.stack([c_xS, c_yS, v_S]),
    ])
    return (ea, eb, Ba, Bb), cov


@functools.partial(jax.jit, static_argnames=("n_paths",))
def _g2_simulate_core(params, ts, key, n_paths):
    dtype = ts.dtype
    dts = jnp.diff(ts)

    def moments(dt):
        return g2_joint_increment_moments(params, dt)

    (eas, ebs, Bas, Bbs), covs = jax.vmap(moments)(dts)
    chols = jnp.linalg.cholesky(
        covs + 1e-18 * jnp.eye(3, dtype=dtype))        # (n_steps, 3, 3)
    das = g2_phi_integral(params, ts[:-1], ts[1:])

    def step(carry, inp):
        xv, yv, logd = carry
        ea, eb, Ba, Bb, L, da, k_t = inp
        z = jax.random.normal(k_t, (3, n_paths), dtype)
        eps = L @ z                                     # (3, n_paths)
        x_new = xv * ea + eps[0]
        y_new = yv * eb + eps[1]
        S = xv * Ba + yv * Bb + eps[2]
        logd = logd - da - S
        return (x_new, y_new, logd), (x_new, y_new, logd)

    keys = jax.random.split(key, dts.shape[0])
    zero = jnp.zeros((n_paths,), dtype)
    _, (xs, ys, logds) = jax.lax.scan(
        step, (zero, zero, zero), (eas, ebs, Bas, Bbs, chols, das, keys))
    return xs, ys, logds


def g2_simulate(params: G2Params, times, key, *, n_paths: int = 65536):
    """Exact path panel of ``(x, y, log D)`` at the given ``times``
    (strictly increasing, > 0): ``D`` is the path's money-market discount
    ``e^{-int_0^t r ds}`` — exact in distribution, so
    ``mean(e^{logD_j}) -> P(0, t_j)`` with pure MC error."""
    times = jnp.asarray(times)
    dtype = result_dtype(times, params.sigma)
    ts = jnp.concatenate([jnp.zeros((1,), dtype), times.astype(dtype)])
    return _g2_simulate_core(params, ts, key, n_paths)
