"""Black-Scholes closed forms and vectorized implied volatility.

JAX redesign of the reference's two BS stacks:

* the C++ internals used for Heston implied vol
  (src/cpp/models/heston.cpp:275-349), and
* the Python pricing stack in data/options.py:118-455 (full price/Greeks and
  a Newton-Raphson IV solver with Brenner-Subrahmanyam initialisation).

Everything here is a pure, broadcasting jnp function: one call prices/inverts
an entire chain.  The IV solver is a fixed-iteration masked Newton loop (no
data-dependent Python control flow) so it jits, vmaps and shards cleanly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.stats import norm_cdf, norm_pdf

__all__ = [
    "price",
    "vega",
    "delta",
    "gamma",
    "theta",
    "rho",
    "greeks",
    "implied_vol",
    "barrier_price",
    "digital_price",
    "no_touch_prob",
    "touch_price",
]


def _d1_d2(spot, strike, rate, dividend, maturity, vol):
    forward = spot * jnp.exp((rate - dividend) * maturity)
    sqrt_t = jnp.sqrt(maturity)
    vs = vol * sqrt_t
    d1 = (jnp.log(forward / strike) + 0.5 * vol * vol * maturity) / vs
    d2 = d1 - vs
    return d1, d2


@jax.jit
def price(spot, strike, rate, dividend, maturity, vol, is_call=True):
    """European Black-Scholes price (broadcasts over all arguments).

    Matches HestonModel::black_scholes_price (src/cpp/models/heston.cpp:275-294)
    including the intrinsic-value shortcut at zero maturity.
    """
    spot, strike, maturity, vol = jnp.broadcast_arrays(
        *map(jnp.asarray, (spot, strike, maturity, vol))
    )
    safe_T = jnp.where(maturity > 0.0, maturity, 1.0)
    safe_vol = jnp.where(vol > 0.0, vol, 1e-12)
    d1, d2 = _d1_d2(spot, strike, rate, dividend, safe_T, safe_vol)
    disc_r = jnp.exp(-rate * safe_T)
    disc_q = jnp.exp(-dividend * safe_T)

    call = spot * disc_q * norm_cdf(d1) - strike * disc_r * norm_cdf(d2)
    put = strike * disc_r * norm_cdf(-d2) - spot * disc_q * norm_cdf(-d1)
    val = jnp.where(is_call, call, put)

    intrinsic = jnp.where(is_call, jnp.maximum(spot - strike, 0.0), jnp.maximum(strike - spot, 0.0))
    return jnp.where(maturity <= 0.0, intrinsic, val)


@jax.jit
def vega(spot, strike, rate, dividend, maturity, vol):
    """dV/dsigma.  Matches src/cpp/models/heston.cpp:296-309."""
    spot, strike, maturity, vol = jnp.broadcast_arrays(
        *map(jnp.asarray, (spot, strike, maturity, vol))
    )
    ok = (maturity > 0.0) & (vol > 0.0)
    safe_T = jnp.where(ok, maturity, 1.0)
    safe_vol = jnp.where(ok, vol, 1.0)
    d1, _ = _d1_d2(spot, strike, rate, dividend, safe_T, safe_vol)
    v = spot * jnp.exp(-dividend * safe_T) * jnp.sqrt(safe_T) * norm_pdf(d1)
    return jnp.where(ok, v, 0.0)


@jax.jit
def delta(spot, strike, rate, dividend, maturity, vol, is_call=True):
    d1, _ = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    dq = jnp.exp(-dividend * maturity)
    return jnp.where(is_call, dq * norm_cdf(d1), dq * (norm_cdf(d1) - 1.0))


@jax.jit
def gamma(spot, strike, rate, dividend, maturity, vol):
    d1, _ = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    return jnp.exp(-dividend * maturity) * norm_pdf(d1) / (spot * vol * jnp.sqrt(maturity))


@jax.jit
def theta(spot, strike, rate, dividend, maturity, vol, is_call=True):
    """Calendar theta (per year).  Reference: data/options.py BS Greeks."""
    d1, d2 = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    dq = jnp.exp(-dividend * maturity)
    dr = jnp.exp(-rate * maturity)
    decay = -spot * dq * norm_pdf(d1) * vol / (2.0 * jnp.sqrt(maturity))
    call = decay - rate * strike * dr * norm_cdf(d2) + dividend * spot * dq * norm_cdf(d1)
    put = decay + rate * strike * dr * norm_cdf(-d2) - dividend * spot * dq * norm_cdf(-d1)
    return jnp.where(is_call, call, put)


@jax.jit
def rho(spot, strike, rate, dividend, maturity, vol, is_call=True):
    _, d2 = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    dr = jnp.exp(-rate * maturity)
    return jnp.where(
        is_call,
        strike * maturity * dr * norm_cdf(d2),
        -strike * maturity * dr * norm_cdf(-d2),
    )


@jax.jit
def greeks(spot, strike, rate, dividend, maturity, vol, is_call=True):
    """All first/second-order BS Greeks as a dict of broadcast arrays."""
    return {
        "delta": delta(spot, strike, rate, dividend, maturity, vol, is_call),
        "gamma": gamma(spot, strike, rate, dividend, maturity, vol),
        "vega": vega(spot, strike, rate, dividend, maturity, vol),
        "theta": theta(spot, strike, rate, dividend, maturity, vol, is_call),
        "rho": rho(spot, strike, rate, dividend, maturity, vol, is_call),
    }


@functools.partial(jax.jit, static_argnames=("barrier_type",))
def barrier_price(
    spot,
    strike,
    barrier,
    rate,
    dividend,
    maturity,
    vol,
    barrier_type: str = "up-and-out",
    is_call=True,
):
    """Continuously monitored single-barrier option (Reiner-Rubinstein 1991).

    Zero rebate.  ``barrier_type`` is one of up/down-and-in/out; all model
    arguments broadcast.  Options already beyond the barrier at t=0 are
    treated as knocked (out -> 0, in -> vanilla).  The framework's oracle
    for the Heston barrier PDE (solvers/barrier_pde.py) in the small
    vol-of-vol limit and a pricing surface the reference platform (which has
    no exotics engine — its closest is the vanilla chain pricer in
    data/options.py:118-455) does not offer.
    """
    direction, _, inout = barrier_type.partition("-and-")
    if direction not in ("up", "down") or inout not in ("in", "out"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")

    S, K, B, T, sig = jnp.broadcast_arrays(
        *map(jnp.asarray, (spot, strike, barrier, maturity, vol))
    )
    is_call = jnp.broadcast_to(jnp.asarray(is_call), S.shape)
    phi = jnp.where(is_call, 1.0, -1.0)
    eta = 1.0 if direction == "down" else -1.0

    vs = sig * jnp.sqrt(T)
    mu = (rate - dividend) / (sig * sig) - 0.5
    df_r = jnp.exp(-rate * T)
    df_q = jnp.exp(-dividend * T)

    x1 = jnp.log(S / K) / vs + (1.0 + mu) * vs
    x2 = jnp.log(S / B) / vs + (1.0 + mu) * vs
    y1 = jnp.log(B * B / (S * K)) / vs + (1.0 + mu) * vs
    y2 = jnp.log(B / S) / vs + (1.0 + mu) * vs
    pow1 = (B / S) ** (2.0 * (mu + 1.0))
    pow2 = (B / S) ** (2.0 * mu)

    def _plain(x):
        return phi * S * df_q * norm_cdf(phi * x) - phi * K * df_r * norm_cdf(
            phi * (x - vs)
        )

    def _refl(y):
        return phi * S * df_q * pow1 * norm_cdf(eta * y) - phi * K * df_r * (
            pow2 * norm_cdf(eta * (y - vs))
        )

    A = _plain(x1)
    Bv = _plain(x2)
    C = _refl(y1)
    D = _refl(y2)

    k_above = K > B  # strike above the barrier level
    if direction == "down":
        in_val = jnp.where(
            is_call,
            jnp.where(k_above, C, A - Bv + D),
            jnp.where(k_above, Bv - C + D, A),
        )
    else:
        in_val = jnp.where(
            is_call,
            jnp.where(k_above, A, Bv - C + D),
            jnp.where(k_above, A - Bv + D, C),
        )

    vanilla = price(S, K, rate, dividend, T, sig, is_call)
    in_val = jnp.clip(in_val, 0.0, vanilla)
    knocked = (S >= B) if direction == "up" else (S <= B)
    in_val = jnp.where(knocked, vanilla, in_val)
    if inout == "in":
        return in_val
    return vanilla - in_val


@functools.partial(jax.jit, static_argnames=("kind",))
def digital_price(spot, strike, rate, dividend, maturity, vol, is_call=True,
                  kind: str = "cash"):
    """Digital (binary) option closed form.

    ``kind="cash"``: pays 1 at expiry if in the money —
    ``e^{-rT} N(±d2)``.  ``kind="asset"``: pays S_T —
    ``S e^{-qT} N(±d1)``.  Broadcasts over all arguments.  The
    Black-Scholes oracle for the Gil-Pelaez digitals in
    :mod:`.digital` (small vol-of-vol limit).
    """
    if kind not in ("cash", "asset"):
        raise ValueError(f"kind must be 'cash' or 'asset', got {kind!r}")
    d1, d2 = _d1_d2(spot, strike, rate, dividend, maturity, vol)
    sign = jnp.where(jnp.asarray(is_call), 1.0, -1.0)
    if kind == "cash":
        return jnp.exp(-rate * maturity) * norm_cdf(sign * d2)
    return spot * jnp.exp(-dividend * maturity) * norm_cdf(sign * d1)


@jax.jit
def no_touch_prob(spot, barrier, rate, dividend, maturity, vol):
    """Risk-neutral probability the GBM path NEVER touches ``barrier``
    on [0, T] (continuous monitoring), by the reflection principle.

    With X_t = ln(S_t/S_0) = nu t + vol W_t, nu = r - q - vol^2/2, and
    b = ln(B/S0):

      up   (b > 0):  P(max X <= b) = N((b - nu T)/s) - e^{2 nu b / vol^2} N((-b - nu T)/s)
      down (b < 0):  P(min X >= b) = N((nu T - b)/s) - e^{2 nu b / vol^2} N((b + nu T)/s)

    with s = vol sqrt(T).  A barrier already touched at t=0 gives 0.
    Broadcasts over all arguments.
    """
    S, B, T, sig = jnp.broadcast_arrays(
        *map(jnp.asarray, (spot, barrier, maturity, vol))
    )
    nu = rate - dividend - 0.5 * sig * sig
    b = jnp.log(B / S)
    s = sig * jnp.sqrt(T)
    refl = jnp.exp(2.0 * nu * b / (sig * sig))
    p_up = norm_cdf((b - nu * T) / s) - refl * norm_cdf((-b - nu * T) / s)
    p_down = norm_cdf((nu * T - b) / s) - refl * norm_cdf((b + nu * T) / s)
    p = jnp.where(b > 0.0, p_up, p_down)
    return jnp.clip(jnp.where(b == 0.0, 0.0, p), 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("touch",))
def touch_price(spot, barrier, rate, dividend, maturity, vol,
                touch: bool = True):
    """One-touch (``touch=True``) / no-touch cash digital paying 1 at
    EXPIRY, continuously monitored:  ``e^{-rT} P(hit)`` /
    ``e^{-rT} P(no hit)`` with the reflection-principle probability from
    :func:`no_touch_prob`.  (Pay-at-hit variants discount from the hitting
    time and are a different closed form — not offered here.)"""
    p_no = no_touch_prob(spot, barrier, rate, dividend, maturity, vol)
    p = 1.0 - p_no if touch else p_no
    return jnp.exp(-jnp.asarray(rate) * jnp.asarray(maturity)) * p


def _brenner_subrahmanyam_init(target, spot, strike, rate, dividend, maturity):
    """sigma ~ sqrt(2 pi / T) * P / S initial guess (data/options.py:260-320)."""
    approx = jnp.sqrt(2.0 * jnp.pi / maturity) * target / spot
    del strike, rate, dividend
    return jnp.clip(approx, 0.05, 2.0)


@functools.partial(jax.jit, static_argnames=("max_iter", "tol"))
def implied_vol(
    target_price,
    spot,
    strike,
    rate,
    dividend,
    maturity,
    is_call=True,
    init_vol=None,
    max_iter: int = 100,
    tol: float = 1e-8,
):
    """Vectorized Newton-Raphson implied volatility.

    Reproduces the reference solver semantics
    (HestonModel::implied_volatility, src/cpp/models/heston.cpp:311-349):

    * when local vega < 1e-12 the vol is multiplied by 1.5 and iteration
      continues;
    * otherwise a Newton step clipped into [0.001, 5.0] is taken;
    * iteration stops (per element, via masking) once |BS - target| < tol.

    ``init_vol`` defaults to a Brenner-Subrahmanyam guess
    (data/options.py:260-320); pass ``sqrt(v0)`` to match the C++ Heston IV.
    """
    target_price, spot, strike, maturity = jnp.broadcast_arrays(
        *map(jnp.asarray, (target_price, spot, strike, maturity))
    )
    if init_vol is None:
        vol0 = _brenner_subrahmanyam_init(target_price, spot, strike, rate, dividend, maturity)
    else:
        vol0 = jnp.broadcast_to(jnp.asarray(init_vol, dtype=target_price.dtype), target_price.shape)

    done0 = jnp.zeros(target_price.shape, dtype=bool)

    def body(_, state):
        vol, done = state
        bs = price(spot, strike, rate, dividend, maturity, vol, is_call)
        vg = vega(spot, strike, rate, dividend, maturity, vol)
        diff = bs - target_price

        # damped Newton: cap each move at 2x — a barely-nonzero vega on
        # deep-OTM quotes makes the raw step explode into a 0.005 <-> 5.0
        # oscillation that never converges (same guard as the native oracle)
        raw = vol - diff / jnp.where(vg < 1e-12, 1.0, vg)
        newton = jnp.clip(jnp.clip(raw, 0.5 * vol, 2.0 * vol), 0.001, 5.0)
        proposal = jnp.where(vg < 1e-12, jnp.minimum(vol * 1.5, 5.0), newton)

        new_done = done | (jnp.abs(diff) < tol)
        vol = jnp.where(new_done, vol, proposal)
        return vol, new_done

    vol, _ = jax.lax.fori_loop(0, max_iter, body, (vol0, done0))
    return jnp.where(maturity <= 0.0, 0.0, vol)
