"""Interest-rate models: discount curves, Vasicek/CIR affine
bonds, and the Hull-White (extended-Vasicek) short-rate model with
closed-form bond options, caps/floors, and Jamshidian swaptions.

Model family beyond the reference (dharvpat/PDE ships equity-side models
only — Heston/SABR/OU at /root/reference/src/cpp/models/); the OU machinery
here is the same mathematical object as the reference's mean-reversion
engine (src/cpp/models/ou_process.cpp:230-256 exact discretization), lifted
to the risk-neutral short-rate setting.

Design (device-first):

* A :class:`DiscountCurve` is a pair of arrays ``(times, dfs)`` with
  log-linear interpolation (piecewise-constant instantaneous forwards) —
  pure ``jnp.interp`` on log-discounts, so every curve read is vectorized
  and jit/vmap/grad-safe.  No Python objects, no callables: curves are
  pytrees and shard like any other batch axis.
* All pricers are closed-form affine expressions (matmul-free, vector
  elementwise) built to broadcast: maturities, strikes, and tenors may all
  be arrays.
* The Jamshidian swaption decomposition solves for the critical short rate
  with a fixed-trip-count Newton iteration (compiler-friendly: no
  data-dependent Python control flow), then prices the coupon-bond option
  as a strip of ZCB options in one broadcasted expression.
* Monte Carlo uses the exact OU transition (no discretization bias in the
  factor) inside ``lax.scan``, with a trapezoid accumulator for the money-
  market account so ``E[e^{-int r}]`` reproduces the input curve to MC
  error — the martingale test pins it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.precision import result_dtype
from ..utils.stats import norm_cdf as _norm_cdf

__all__ = [
    "DiscountCurve",
    "VasicekParams",
    "CIRParams",
    "HullWhiteParams",
    "flat_curve",
    "curve_from_zero_rates",
    "vasicek_bond",
    "vasicek_bond_option",
    "cir_bond",
    "hw_bond",
    "hw_bond_option",
    "hw_caplet",
    "hw_floorlet",
    "hw_cap",
    "hw_swap_rate",
    "hw_swaption",
    "hw_simulate",
    "bachelier_price",
    "bachelier_implied_vol",
    "black_caplet_price",
    "black_cap_price",
    "strip_caplet_vols",
]


# ---------------------------------------------------------------------------
# discount curve


class DiscountCurve(NamedTuple):
    """Market discount curve: ``dfs[i] = P(0, times[i])``.

    ``times`` must be strictly increasing and positive; ``P(0, 0) = 1`` is
    implicit.  Interpolation is linear in ``log P`` (piecewise-constant
    forward rates), flat-forward extrapolated beyond the last pillar.
    """

    times: jnp.ndarray
    dfs: jnp.ndarray

    def df(self, t):
        """P(0, t) — broadcasts over ``t``."""
        t = jnp.asarray(t)
        log_dfs = jnp.log(self.dfs)
        # prepend the implicit (0, 1) pillar; extrapolate flat-forward using
        # the last segment's slope
        times = jnp.concatenate([jnp.zeros((1,), self.times.dtype), self.times])
        logs = jnp.concatenate([jnp.zeros((1,), log_dfs.dtype), log_dfs])
        slope_end = (logs[-1] - logs[-2]) / (times[-1] - times[-2])
        inside = jnp.interp(t, times, logs)
        out = jnp.where(
            t > times[-1], logs[-1] + slope_end * (t - times[-1]), inside
        )
        return jnp.exp(out)

    def zero_rate(self, t):
        """Continuously-compounded zero rate: ``-log P(0,t) / t``."""
        t = jnp.asarray(t)
        return -jnp.log(self.df(t)) / jnp.where(t > 0, t, 1.0)

    def forward(self, t1, t2):
        """Simply-compounded forward rate over ``[t1, t2]``."""
        tau = jnp.asarray(t2) - jnp.asarray(t1)
        return (self.df(t1) / self.df(t2) - 1.0) / tau

    def inst_forward(self, t, eps: float = 1e-5):
        """Instantaneous forward ``f(0, t) = -d log P / dt`` by a symmetric
        difference — exact in the interior of each flat-forward segment."""
        t = jnp.asarray(t)
        lo = jnp.maximum(t - eps, 0.0)
        return (jnp.log(self.df(lo)) - jnp.log(self.df(t + eps))) / (t + eps - lo)


def flat_curve(rate, horizon: float = 50.0, n: int = 2, dtype=None):
    """Constant-rate curve ``P(0,t) = e^{-rate t}``."""
    dt = dtype or result_dtype(rate)
    times = jnp.linspace(horizon / n, horizon, n, dtype=dt)
    return DiscountCurve(times, jnp.exp(-jnp.asarray(rate, dt) * times))


def curve_from_zero_rates(times, zero_rates):
    """Curve from continuously-compounded zero rates at pillar times."""
    times = jnp.asarray(times)
    zr = jnp.asarray(zero_rates)
    return DiscountCurve(times, jnp.exp(-zr * times))


# ---------------------------------------------------------------------------
# Vasicek: dr = kappa (theta - r) dt + sigma dW


class VasicekParams(NamedTuple):
    kappa: jnp.ndarray
    theta: jnp.ndarray
    sigma: jnp.ndarray
    r0: jnp.ndarray

    def validate(self):
        if float(self.kappa) <= 0:
            raise ValueError("kappa must be positive")
        if float(self.sigma) <= 0:
            raise ValueError("sigma must be positive")
        return self


def _affine_b(a, tau):
    """B(tau) = (1 - e^{-a tau}) / a, with the a -> 0 limit tau."""
    small = jnp.abs(a) < 1e-12
    a_safe = jnp.where(small, 1.0, a)
    return jnp.where(small, tau, -jnp.expm1(-a_safe * tau) / a_safe)


def vasicek_bond(params: VasicekParams, maturity, t=0.0, r=None):
    """P(t, T) = A e^{-B r} under Vasicek (affine closed form)."""
    tau = jnp.asarray(maturity) - jnp.asarray(t)
    r = params.r0 if r is None else r
    k, th, sig = params.kappa, params.theta, params.sigma
    B = _affine_b(k, tau)
    lnA = (th - sig * sig / (2.0 * k * k)) * (B - tau) - sig * sig * B * B / (4.0 * k)
    return jnp.exp(lnA - B * r)


def vasicek_bond_option(
    params: VasicekParams, strike, expiry, bond_maturity, is_call=True
):
    """European option (expiry ``T0``) on a ZCB maturing at ``T1 > T0``:
    the Jamshidian (1989) closed form — lognormal bond-price dynamics."""
    T0 = jnp.asarray(expiry)
    T1 = jnp.asarray(bond_maturity)
    k, sig = params.kappa, params.sigma
    p0 = vasicek_bond(params, T0)
    p1 = vasicek_bond(params, T1)
    sig_p = (
        sig
        * _affine_b(k, T1 - T0)
        * jnp.sqrt(-jnp.expm1(-2.0 * k * T0) / (2.0 * k))
    )
    return _zcb_option_black(p0, p1, strike, sig_p, is_call)


def _zcb_option_black(df_expiry, df_bond, strike, sig_p, is_call):
    """Black-style ZCB option kernel shared by Vasicek and Hull-White:
    price = P1 N(h) - K P0 N(h - sig_p) (call), with put by parity."""
    sig_p = jnp.maximum(sig_p, 1e-12)
    h = jnp.log(df_bond / (df_expiry * strike)) / sig_p + 0.5 * sig_p
    call = df_bond * _norm_cdf(h) - strike * df_expiry * _norm_cdf(h - sig_p)
    if isinstance(is_call, bool):
        return call if is_call else call - df_bond + strike * df_expiry
    return jnp.where(is_call, call, call - df_bond + strike * df_expiry)


# ---------------------------------------------------------------------------
# CIR: dr = kappa (theta - r) dt + sigma sqrt(r) dW


class CIRParams(NamedTuple):
    kappa: jnp.ndarray
    theta: jnp.ndarray
    sigma: jnp.ndarray
    r0: jnp.ndarray

    def feller(self) -> bool:
        return float(2.0 * self.kappa * self.theta) > float(self.sigma**2)


def cir_bond(params: CIRParams, maturity, t=0.0, r=None):
    """P(t, T) under CIR (Cox-Ingersoll-Ross 1985 closed form)."""
    tau = jnp.asarray(maturity) - jnp.asarray(t)
    r = params.r0 if r is None else r
    k, th, sig = params.kappa, params.theta, params.sigma
    g = jnp.sqrt(k * k + 2.0 * sig * sig)
    # stable form in e^{-g tau}: the textbook (e^{g tau}-1) expressions
    # overflow for stiff kappa (g tau >~ 700); multiply through by e^{-g tau}
    em = -jnp.expm1(-g * tau)  # 1 - e^{-g tau}
    denom = (g + k) * em / 2.0 + g * jnp.exp(-g * tau)
    B = em / denom
    lnA = (2.0 * k * th / (sig * sig)) * (
        jnp.log(g) + 0.5 * (k - g) * tau - jnp.log(denom)
    )
    return jnp.exp(lnA - B * r)


# ---------------------------------------------------------------------------
# Hull-White: dr = (theta(t) - a r) dt + sigma dW, fitted to the input curve


class HullWhiteParams(NamedTuple):
    """Hull-White one-factor with the market :class:`DiscountCurve` embedded
    — the model reproduces ``curve.df(T)`` for every T by construction, so
    calibration only fits ``(a, sigma)`` to option quotes."""

    a: jnp.ndarray
    sigma: jnp.ndarray
    curve: DiscountCurve

    def validate(self):
        if float(self.a) <= 0:
            raise ValueError("mean reversion a must be positive")
        if float(self.sigma) <= 0:
            raise ValueError("sigma must be positive")
        return self


def hw_bond(params: HullWhiteParams, maturity, t=0.0, r=None):
    """P(t, T | r_t) — the Hull-White affine reconstruction from the market
    curve.  At ``t = 0`` (``r = None``) it returns ``curve.df(T)`` exactly.
    """
    if r is None:
        return params.curve.df(maturity)
    a, sig, curve = params.a, params.sigma, params.curve
    t = jnp.asarray(t)
    T = jnp.asarray(maturity)
    B = _affine_b(a, T - t)
    f0t = curve.inst_forward(t)
    lnA = (
        jnp.log(curve.df(T) / curve.df(t))
        + B * f0t
        - sig * sig / (4.0 * a) * -jnp.expm1(-2.0 * a * t) * B * B
    )
    return jnp.exp(lnA - B * r)


def hw_bond_option(
    params: HullWhiteParams, strike, expiry, bond_maturity, is_call=True
):
    """European ZCB option under Hull-White — Black kernel with

        sig_p = sigma B(T0, T1) sqrt((1 - e^{-2 a T0}) / (2a)).
    """
    a, sig, curve = params.a, params.sigma, params.curve
    T0 = jnp.asarray(expiry)
    T1 = jnp.asarray(bond_maturity)
    sig_p = (
        sig * _affine_b(a, T1 - T0) * jnp.sqrt(-jnp.expm1(-2.0 * a * T0) / (2.0 * a))
    )
    return _zcb_option_black(curve.df(T0), curve.df(T1), strike, sig_p, is_call)


def hw_caplet(params: HullWhiteParams, strike_rate, start, end, notional=1.0):
    """Caplet on the simple forward over ``[start, end]``, settled at
    ``end``: equivalent to ``(1 + tau K)`` puts on the ZCB P(start, end)
    struck at ``1 / (1 + tau K)`` (standard static replication)."""
    tau = jnp.asarray(end) - jnp.asarray(start)
    kb = 1.0 / (1.0 + tau * jnp.asarray(strike_rate))
    put = hw_bond_option(params, kb, start, end, is_call=False)
    return notional * (1.0 + tau * strike_rate) * put


def hw_floorlet(params: HullWhiteParams, strike_rate, start, end, notional=1.0):
    tau = jnp.asarray(end) - jnp.asarray(start)
    kb = 1.0 / (1.0 + tau * jnp.asarray(strike_rate))
    call = hw_bond_option(params, kb, start, end, is_call=True)
    return notional * (1.0 + tau * strike_rate) * call


def hw_cap(params: HullWhiteParams, strike_rate, pay_times, notional=1.0):
    """Cap = strip of caplets over consecutive ``pay_times`` (the first
    element is the start of the first accrual; no caplet pays on it)."""
    pt = jnp.asarray(pay_times)
    lets = hw_caplet(params, strike_rate, pt[:-1], pt[1:], notional)
    return jnp.sum(lets, axis=-1)


def hw_swap_rate(curve: DiscountCurve, start, pay_times):
    """Par swap rate for a swap starting at ``start`` paying the fixed leg
    at ``pay_times`` (annuity-weighted forward)."""
    pt = jnp.asarray(pay_times)
    taus = jnp.diff(jnp.concatenate([jnp.asarray(start)[None], pt]))
    annuity = jnp.sum(taus * curve.df(pt))
    return (curve.df(start) - curve.df(pt[-1])) / annuity


def _hw_critical_rate(params, expiry, pay_times, coupons, n_newton: int = 30):
    """Jamshidian critical short rate r*: coupon bond price at expiry = 1.

    Fixed-trip Newton (the bond price is monotone decreasing and convex in
    r, so Newton from 0 converges quadratically; 30 trips is far past
    float64 convergence and keeps the control flow static for XLA).
    """

    def bond(r):
        return jnp.sum(coupons * hw_bond(params, pay_times, expiry, r), axis=-1)

    dbond = jax.grad(lambda r: bond(r))

    def body(r, _):
        r_new = r - (bond(r) - 1.0) / dbond(r)
        return r_new, None

    r0 = jnp.asarray(0.0, jnp.result_type(params.sigma, float))
    r_star, _ = jax.lax.scan(body, r0, None, length=n_newton)
    return r_star


def hw_swaption(
    params: HullWhiteParams, strike_rate, expiry, pay_times,
    notional=1.0, payer=True, n_newton: int = 30,
):
    """European swaption via the Jamshidian (1989) decomposition.

    A payer swaption (right to pay fixed ``K``) is a put on the coupon bond
    with coupons ``tau_i K`` (+1 at the final date) struck at par; in a
    one-factor model the coupon-bond option decomposes exactly into ZCB
    options struck at each bond's value at the critical rate ``r*``.
    """
    expiry = jnp.asarray(expiry)
    pt = jnp.asarray(pay_times)
    taus = jnp.diff(jnp.concatenate([expiry[None], pt]))
    coupons = taus * jnp.asarray(strike_rate)
    coupons = coupons.at[-1].add(1.0)
    r_star = _hw_critical_rate(params, expiry, pt, coupons, n_newton)
    strikes = hw_bond(params, pt, expiry, r_star)  # K_i = P(T0, T_i; r*)
    # payer swaption = sum_i c_i * ZCB-put(K_i); receiver = calls
    opts = hw_bond_option(params, strikes, expiry, pt, is_call=not payer)
    return notional * jnp.sum(coupons * opts, axis=-1)


# ---------------------------------------------------------------------------
# simulation


def hw_alpha(params: HullWhiteParams, t):
    """Deterministic shift alpha(t) = f(0,t) + sigma^2/(2a^2) (1-e^{-at})^2
    with r(t) = x(t) + alpha(t), x an OU(0) factor."""
    a, sig, curve = params.a, params.sigma, params.curve
    one = -jnp.expm1(-a * jnp.asarray(t))
    return curve.inst_forward(t) + sig * sig / (2.0 * a * a) * one * one


@functools.partial(jax.jit, static_argnames=("n_paths", "dtype"))
def _hw_simulate_core(a, sig, alphas, dt, n_paths, key, dtype):
    e = jnp.exp(-a * dt)
    sd = sig * jnp.sqrt(-jnp.expm1(-2.0 * a * dt) / (2.0 * a))

    def step(carry, inp):
        x, integ = carry
        k_t, al_prev, al_new = inp
        z = jax.random.normal(k_t, (n_paths,), dtype)
        x_new = x * e + sd * z
        # trapezoid on r = x + alpha across the step
        integ = integ + 0.5 * ((x + al_prev) + (x_new + al_new)) * dt
        return (x_new, integ), x_new + al_new

    n_steps = alphas.shape[0] - 1
    keys = jax.random.split(key, n_steps)
    x0 = jnp.zeros((n_paths,), dtype)
    (x, integ), r_path = jax.lax.scan(
        step, (x0, jnp.zeros((n_paths,), dtype)),
        (keys, alphas[:-1] * jnp.ones((n_steps, 1), dtype),
         alphas[1:] * jnp.ones((n_steps, 1), dtype)),
    )
    return r_path, integ


def hw_simulate(
    params: HullWhiteParams, maturity, key, *,
    n_steps: int = 64, n_paths: int = 65536,
):
    """Exact-transition short-rate paths and the integrated rate.

    Returns ``(r_path, int_r)`` with ``r_path`` of shape ``(n_steps,
    n_paths)`` and ``int_r`` the per-path trapezoid of ``int_0^T r dt`` —
    ``E[e^{-int_r}]`` reproduces ``curve.df(T)`` to MC + trapezoid error
    (martingale pin in tests/test_rates.py).
    """
    dtype = result_dtype(maturity, params.sigma)
    T = jnp.asarray(maturity, dtype)
    dt = T / n_steps
    ts = jnp.linspace(0.0, T, n_steps + 1, dtype=dtype)
    alphas = hw_alpha(params, ts)[:, None]
    return _hw_simulate_core(
        jnp.asarray(params.a, dtype), jnp.asarray(params.sigma, dtype),
        alphas, dt, n_paths, key, dtype)


# ---------------------------------------------------------------------------
# Bachelier (normal) quoting — the swaption market's vol convention


def bachelier_price(forward, strike, vol_n, expiry, annuity=1.0,
                    is_call=True):
    """Bachelier (normal) option price on a forward:

        annuity * [ (F - K) Phi(d) + vol_n sqrt(T) phi(d) ],
        d = (F - K) / (vol_n sqrt(T))

    — the payer-swaption quoting model (annuity = sum tau_i P(0, t_i)).
    Puts (receivers) by parity.  Broadcasts over all arguments.
    """
    from ..utils.stats import norm_pdf
    f = jnp.asarray(forward)
    k = jnp.asarray(strike)
    sq = jnp.asarray(vol_n) * jnp.sqrt(jnp.asarray(expiry))
    sq = jnp.maximum(sq, 1e-12)
    d = (f - k) / sq
    call = (f - k) * _norm_cdf(d) + sq * norm_pdf(d)
    put = call - (f - k)
    if isinstance(is_call, bool):
        return annuity * (call if is_call else put)
    return annuity * jnp.where(is_call, call, put)


def bachelier_implied_vol(price, forward, strike, expiry, annuity=1.0,
                          is_call=True, n_newton: int = 30):
    """Invert Bachelier to a normal vol: vega is strictly positive, so a
    fixed-trip safeguarded Newton from the Brenner-Subrahmanyam ATM seed
    converges for any arbitrage-free price.  jit/vmap/grad-safe.
    """
    from ..utils.stats import norm_pdf
    p = jnp.asarray(price) / annuity
    f = jnp.asarray(forward)
    k = jnp.asarray(strike)
    T = jnp.asarray(expiry)
    sqT = jnp.sqrt(T)
    intrinsic = jnp.where(jnp.asarray(is_call), jnp.maximum(f - k, 0.0),
                          jnp.maximum(k - f, 0.0))
    time_val = jnp.maximum(p - intrinsic, 1e-16)
    # ATM seed: price = vol sqrt(T) / sqrt(2 pi)  ->  vol ~ p sqrt(2pi/T);
    # away from ATM the straddle-consistent seed still lands in the basin
    v0 = (time_val + 0.5 * jnp.abs(f - k)) * jnp.sqrt(2.0 * jnp.pi) / sqT

    def body(v, _):
        sq = jnp.maximum(v * sqT, 1e-14)
        d = (f - k) / sq
        call = (f - k) * _norm_cdf(d) + sq * norm_pdf(d)
        model = jnp.where(jnp.asarray(is_call), call, call - (f - k))
        vega = sqT * norm_pdf(d)
        step = (model - p) / jnp.maximum(vega, 1e-14)
        v_new = jnp.clip(v - step, 1e-10, 10.0)
        return v_new, None

    v, _ = jax.lax.scan(body, v0, None, length=n_newton)
    return v


# ---------------------------------------------------------------------------
# Black-76 (lognormal) quoting + caplet vol stripping — the CAP market's
# vol convention (swaptions quote Bachelier above).  The stripping closes
# the quote-to-calibration loop: market flat cap vols -> forward caplet
# vols -> caplet PRICES -> calibrate.rates.HullWhiteCalibrator (which
# takes prices by design, heston_calibrator.py:486-513 objective parity).


def black_caplet_price(curve: DiscountCurve, strike_rate, start, end, vol,
                       notional=1.0):
    """Black-76 caplet: the rate fixes at ``start``, pays at ``end``.

        tau P(0, end) [ F Phi(d1) - K Phi(d2) ],
        d1 = (ln(F/K) + v^2 start / 2) / (v sqrt(start))

    with F the simple forward over [start, end].  Broadcasts over all
    arguments (vectorize strikes/expiries freely).
    """
    start = jnp.asarray(start)
    end = jnp.asarray(end)
    k = jnp.asarray(strike_rate)
    v = jnp.asarray(vol)
    f = curve.forward(start, end)
    tau = end - start
    sq = jnp.maximum(v * jnp.sqrt(start), 1e-12)
    d1 = (jnp.log(jnp.maximum(f, 1e-12) / jnp.maximum(k, 1e-12))
          + 0.5 * sq * sq) / sq
    d2 = d1 - sq
    return (notional * tau * curve.df(end)
            * (f * _norm_cdf(d1) - k * _norm_cdf(d2)))


def black_cap_price(curve: DiscountCurve, strike_rate, maturity, vol,
                    freq: float = 0.25, notional=1.0, first_reset=None):
    """Cap = caplet strip at ONE flat Black vol (the market quote).

    Resets every ``freq`` years from ``first_reset`` (default ``freq`` —
    the spot-starting convention skips the already-fixed first period) to
    ``maturity``; concrete schedule, traced vol/strike/curve.
    """
    import numpy as np

    m = float(maturity)
    f0 = float(freq if first_reset is None else first_reset)
    starts = jnp.asarray(np.arange(f0, m - 1e-9, float(freq)))
    ends = starts + float(freq)
    return jnp.sum(black_caplet_price(
        curve, strike_rate, starts, ends, vol, notional))


_STRIP_JIT_CACHE: dict = {}


def strip_caplet_vols(curve: DiscountCurve, strike_rate, cap_maturities,
                      flat_vols, freq: float = 0.25, n_newton: int = 20):
    """Bootstrap FORWARD caplet vols from flat cap vols.

    Market caps quote one flat Black vol per maturity; consistent caplet
    pricing needs the forward vol term structure.  Standard strip: for
    each successive cap, the caplets added since the previous maturity
    share one forward vol, solved (fixed-trip safeguarded Newton, Black
    vega > 0) so the strip reprices the cap at its flat vol exactly —
    the same pricer-consistent sequential-bootstrap pattern as
    models/credit.bootstrap_hazard, and like it the whole strip runs as
    ONE jitted program cached per (maturity grid, freq).

    Returns ``(starts, ends, fwd_vols)`` — per-caplet reset schedule and
    forward vols, ready to price with :func:`black_caplet_price` and
    feed :meth:`pde_tpu.calibrate.rates.HullWhiteCalibrator.calibrate_caplets`.
    Cap maturities must be concrete; strike/vols/curve may be traced.
    """
    import numpy as np

    mats = tuple(float(t) for t in np.asarray(cap_maturities))
    key = (mats, float(freq), int(n_newton))
    fn = _STRIP_JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(functools.partial(
            _strip_impl, mats=mats, freq=float(freq), n_newton=int(n_newton)))
        _STRIP_JIT_CACHE[key] = fn
    return fn(curve, jnp.asarray(strike_rate), jnp.asarray(flat_vols))


def _strip_impl(curve, strike_rate, flat_vols, *, mats, freq, n_newton):
    import numpy as np

    starts_np = np.arange(freq, mats[-1] - 1e-9, freq)
    starts = jnp.asarray(starts_np)
    ends = starts + freq
    dtype = result_dtype(flat_vols, curve.dfs)

    # cap prices at their quoted flat vols (the strip's targets)
    caps = []
    for i, m in enumerate(mats):
        in_cap = starts_np < m - 1e-9
        caps.append(jnp.sum(jnp.where(
            jnp.asarray(in_cap),
            black_caplet_price(curve, strike_rate, starts, ends,
                               flat_vols[i]),
            0.0)))

    fwd_segments = []
    prev_m = 0.0
    prev_strip = jnp.asarray(0.0, dtype)
    for i, m in enumerate(mats):
        new = (starts_np >= prev_m - 1e-9) & (starts_np < m - 1e-9)
        new_mask = jnp.asarray(new)
        target = caps[i] - prev_strip     # value the NEW caplets must add

        def seg_price(v, new_mask=new_mask):
            return jnp.sum(jnp.where(
                new_mask,
                black_caplet_price(curve, strike_rate, starts, ends, v),
                0.0))

        dseg = jax.grad(seg_price)

        def newton(v, _, seg_price=seg_price, dseg=dseg, target=target):
            step = (seg_price(v) - target) / jnp.maximum(dseg(v), 1e-12)
            return jnp.clip(v - step, 1e-4, 5.0), None

        v0 = flat_vols[i].astype(dtype)   # the flat vol is the natural seed
        v_seg, _ = jax.lax.scan(newton, v0, None, length=n_newton)
        fwd_segments.append((new_mask, v_seg))
        prev_strip = prev_strip + seg_price(v_seg)
        prev_m = m

    fwd_vols = jnp.zeros(starts.shape, dtype)
    for new_mask, v_seg in fwd_segments:
        fwd_vols = jnp.where(new_mask, v_seg, fwd_vols)
    return starts.astype(dtype), ends.astype(dtype), fwd_vols
