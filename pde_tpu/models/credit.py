"""Credit: hazard-rate curves, CDS pricing/bootstrap, and CVA.

New family beyond the reference (no credit instruments anywhere in
/root/reference/src); the design mirrors the rates module (models/rates.py):
curves are pytrees of arrays, every pricer is a broadcasted closed-form
expression, and the only iteration anywhere is a fixed-trip Newton inside
``lax.scan`` (the hazard bootstrap), so everything is jit/vmap/grad-safe.

* :class:`HazardCurve` — survival probabilities ``Q(t)`` with log-linear
  interpolation = piecewise-constant hazard rates, the market standard.
* CDS legs under the usual independence assumption (rates ⊥ default):
  premium leg with the half-period accrual-on-default convention,
  protection leg as a sum over default buckets with midpoint discounting
  (ISDA-standard upfront model discretization).
* :func:`bootstrap_hazard` — strictly sequential pillar-by-pillar Newton
  (each pillar's hazard only affects spreads at and beyond it), each
  pillar solved with a fixed-trip Newton ``lax.scan`` against the SAME
  ``cds_legs`` pricer the curve is used with, so repricing recovers the
  input spreads to Newton tolerance by construction.
* CVA.  For a SINGLE swap, the discounted expected exposure at a reset
  date IS a European swaption expiring there (exercise into the remaining
  swap), so :func:`cva_swap_hw` is a closed-form Jamshidian strip — no
  simulation at all.  For a NETTING SET (where max(sum, 0) has no closed
  form) :func:`cva_netting_hw_mc` computes EE by exact-transition
  Hull-White Monte Carlo (zero discretization bias, the same joint
  ``(x, int x)`` law as solvers/bermudan_hw) — and collapses to the
  closed form for a one-swap set, which is the test pin.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import result_dtype
from . import rates
from .rates import DiscountCurve, HullWhiteParams

__all__ = [
    "HazardCurve",
    "flat_hazard",
    "cds_legs",
    "cds_par_spread",
    "cds_par_spreads",
    "cds_value",
    "bootstrap_hazard",
    "cva_swap_hw",
    "SwapTrade",
    "cva_netting_hw_mc",
]


class HazardCurve(NamedTuple):
    """Survival curve: ``survival[i] = Q(tau > times[i])``; log-linear
    interpolation (piecewise-constant hazard), flat-hazard extrapolation.
    Same structure as models/rates.DiscountCurve — a survival probability
    IS a "discount factor" at the hazard rate."""

    times: jnp.ndarray
    survival: jnp.ndarray

    def q(self, t):
        """Q(t): broadcasts over t."""
        return DiscountCurve(self.times, self.survival).df(t)

    def hazard(self, t, eps: float = 1e-5):
        """Instantaneous hazard rate lambda(t)."""
        return DiscountCurve(self.times, self.survival).inst_forward(t, eps)


def flat_hazard(lam, horizon: float = 50.0, dtype=None):
    dt = dtype or result_dtype(lam)
    times = jnp.linspace(horizon / 2, horizon, 2, dtype=dt)
    return HazardCurve(times, jnp.exp(-jnp.asarray(lam, dt) * times))


def _default_buckets(maturity, n_buckets, dtype):
    return jnp.linspace(0.0, maturity, n_buckets + 1).astype(dtype)


def cds_legs(
    curve: DiscountCurve,
    hazard: HazardCurve,
    maturity,
    *,
    recovery=0.4,
    freq: float = 0.25,
    n_buckets: int = 200,
):
    """(premium_leg_per_unit_spread, protection_leg) for a CDS from 0 to
    ``maturity``.

    premium = sum_i tau_i D(t_i) [Q(t_i) + (Q(t_{i-1}) - Q(t_i))/2]
    protect = (1-R) sum_k D(mid_k) (Q(t_{k-1}) - Q(t_k))

    ``maturity`` must be a concrete float (schedule construction); all
    curve/hazard entries may be traced.  The schedule is ``n_pay``
    equally spaced payments ending exactly at ``maturity`` (with
    ``n_pay = round(maturity/freq)``), and the accrual factor tau_i is
    the ACTUAL spacing ``maturity/n_pay`` — so when maturity is not a
    multiple of ``freq`` the accrual windows still tile [0, maturity]
    exactly, with no overlap or gap against the survival-difference
    windows.
    """
    m = float(maturity)
    dtype = result_dtype(curve.dfs, hazard.survival)
    n_pay = max(int(round(m / freq)), 1)
    tau = m / n_pay
    pay = jnp.linspace(tau, m, n_pay, dtype=dtype)
    prev = pay - tau
    q_pay = hazard.q(pay)
    q_prev = hazard.q(prev)
    premium = jnp.sum(
        tau * curve.df(pay) * (q_pay + 0.5 * (q_prev - q_pay)))

    tb = _default_buckets(m, n_buckets, dtype)
    q_b = hazard.q(tb)
    mid = 0.5 * (tb[:-1] + tb[1:])
    protect = (1.0 - recovery) * jnp.sum(
        curve.df(mid) * (q_b[:-1] - q_b[1:]))
    return premium, protect


_PAR_SPREAD_JIT_CACHE: dict = {}


def cds_par_spread(curve, hazard, maturity, *, recovery=0.4,
                   freq: float = 0.25, n_buckets: int = 200):
    """Running spread s* with zero upfront: protection / premium-annuity.

    Jit-cached per (maturity, freq, n_buckets) — the orchestrator's
    round-trip quality gate reprices the same pillars every daily run.
    (``maturity`` must be concrete: it defines the payment schedule,
    same contract as :func:`cds_legs`.)
    """
    key = (float(maturity), float(freq), int(n_buckets))
    fn = _PAR_SPREAD_JIT_CACHE.get(key)
    if fn is None:
        def _impl(curve, hazard, recovery, _key=key):
            m, f, nb = _key
            prem, prot = cds_legs(curve, hazard, m, recovery=recovery,
                                  freq=f, n_buckets=nb)
            return prot / prem

        fn = jax.jit(_impl)
        _PAR_SPREAD_JIT_CACHE[key] = fn
    return fn(curve, hazard, recovery)


def cds_par_spreads(curve, hazard, maturities, *, recovery=0.4,
                    freq: float = 0.25, n_buckets: int = 200):
    """Par spreads for a STRIP of maturities in one jitted program —
    one device dispatch and one pull for the whole pillar grid (the
    orchestrator's round-trip gate uses this).  Returns a (n,) array.
    """
    mats = tuple(float(t) for t in np.asarray(maturities))
    key = (mats, float(freq), int(n_buckets))
    fn = _PAR_SPREAD_JIT_CACHE.get(("strip", key))
    if fn is None:
        def _impl(curve, hazard, recovery, _key=key):
            ms, f, nb = _key
            out = []
            for m in ms:
                prem, prot = cds_legs(curve, hazard, m, recovery=recovery,
                                      freq=f, n_buckets=nb)
                out.append(prot / prem)
            return jnp.stack(out)

        fn = jax.jit(_impl)
        _PAR_SPREAD_JIT_CACHE[("strip", key)] = fn
    return fn(curve, hazard, recovery)


def cds_value(curve, hazard, maturity, spread, *, recovery=0.4,
              notional=1.0, freq: float = 0.25, n_buckets: int = 200):
    """Value to the PROTECTION BUYER of a running-spread CDS."""
    prem, prot = cds_legs(curve, hazard, maturity, recovery=recovery,
                          freq=freq, n_buckets=n_buckets)
    return notional * (prot - jnp.asarray(spread) * prem)


_BOOTSTRAP_JIT_CACHE: dict = {}


def bootstrap_hazard(
    curve: DiscountCurve,
    pillars,
    spreads,
    *,
    recovery=0.4,
    freq: float = 0.25,
    n_buckets: int = 200,
    n_newton: int = 12,
):
    """Piecewise-constant hazard curve from par CDS spreads.

    Strictly sequential pillar-by-pillar fixed-trip Newton, each pillar
    solved against THE SAME pricer the curve is used with
    (:func:`cds_legs`), so repricing the pillars through
    :func:`cds_par_spread` recovers the inputs to Newton tolerance by
    construction.  Pillar times must be concrete (they define payment
    schedules); spreads, curve entries and recovery may be traced.
    Returns ``(HazardCurve, hazards)``.

    The whole bootstrap runs as ONE jitted program cached per pillar
    grid (the daily-orchestrator pattern re-bootstraps the same pillars
    every run) instead of re-tracing the per-pillar Newton closures
    eagerly; the cached program is one dispatch.
    """
    # pillar times must be concrete: go through numpy (works for python
    # sequences and concrete jnp constants even inside a surrounding jit,
    # where iterating a jnp array would produce tracers)
    pillars_f = tuple(float(t) for t in np.asarray(pillars))
    key = (pillars_f, float(freq), int(n_buckets), int(n_newton))
    fn = _BOOTSTRAP_JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(functools.partial(
            _bootstrap_impl, pillars_f=pillars_f, freq=freq,
            n_buckets=n_buckets, n_newton=n_newton))
        _BOOTSTRAP_JIT_CACHE[key] = fn
    return fn(curve, jnp.asarray(spreads), recovery)


def _bootstrap_impl(curve, spreads, recovery, *, pillars_f, freq,
                    n_buckets, n_newton):
    dtype = result_dtype(spreads, curve.dfs)
    spreads = spreads.astype(dtype)
    p_arr = jnp.asarray(pillars_f, dtype)
    n_p = len(pillars_f)
    dts = jnp.diff(jnp.concatenate([jnp.zeros((1,), dtype), p_arr]))

    hs = []
    for i in range(n_p):
        t1 = pillars_f[i]
        s = spreads[i]

        def surv_with(h, i=i):
            """Survival at all pillar times with segment i hazard = h;
            later segments flat-extrapolate h (beyond t1, never read)."""
            if hs:
                hz = jnp.concatenate(
                    [jnp.stack(hs), jnp.full((n_p - i,), h, dtype)])
            else:
                hz = jnp.full((n_p,), h, dtype)
            return jnp.exp(-jnp.cumsum(hz * dts))

        def obj(h, t1=t1, s=s):
            hc = HazardCurve(p_arr, surv_with(h))
            prem, prot = cds_legs(curve, hc, t1, recovery=recovery,
                                  freq=freq, n_buckets=n_buckets)
            return s * prem - prot

        dobj = jax.grad(obj)

        def newton(h, _):
            h_new = h - obj(h) / dobj(h)
            return jnp.clip(h_new, 1e-8, 10.0), None

        # traced-safe seed: the credit-triangle guess s/(1-R), kept as an
        # array so spreads may themselves be tracers (jit/grad/vmap)
        h0 = (spreads[i]
              / jnp.maximum(1.0 - jnp.asarray(recovery, dtype), 1e-6))
        h, _ = jax.lax.scan(newton, h0, None, length=n_newton)
        hs.append(h)

    hazards = jnp.stack(hs)
    survival = jnp.exp(-jnp.cumsum(hazards * dts))
    return HazardCurve(p_arr, survival), hazards


# ---------------------------------------------------------------------------
# CVA


def cva_swap_hw(
    params: HullWhiteParams,
    hazard: HazardCurve,
    strike_rate,
    schedule,
    *,
    recovery=0.4,
    payer: bool = True,
    notional=1.0,
):
    """Closed-form CVA of a single IR swap vs a defaultable counterparty
    (independence assumption).

    The discounted expected positive exposure at reset date T_j equals
    the European swaption expiring at T_j into the remaining swap
    (exercise value = swap value), so

        CVA = (1-R) sum_j  Swaption(T_j) [Q(T_j) - Q(T_{j+1})]

    — a Jamshidian strip, no simulation.  Bucketing convention: default
    in (T_j, T_{j+1}] is paired with the exposure at the BUCKET START
    T_j (the swaption expiring there); default before T_0 contributes
    nothing.  :func:`cva_netting_hw_mc` uses the same start-of-bucket
    convention, which is why the one-swap MC collapse pins this
    closed form.
    """
    schedule = jnp.asarray(schedule)
    m = int(schedule.shape[0]) - 1
    q = hazard.q(schedule)
    swps = jnp.stack([
        rates.hw_swaption(params, strike_rate, schedule[j], schedule[j + 1:],
                          payer=payer)
        for j in range(m)
    ])
    dq = q[:-1] - q[1:]
    return notional * (1.0 - recovery) * jnp.sum(swps * dq[:m])


class SwapTrade(NamedTuple):
    """One swap in a netting set — all trades share the reset ``schedule``
    passed to :func:`cva_netting_hw_mc`.  ``payer_sign`` = +1 pays fixed
    (gains when rates rise), -1 receives fixed."""

    strike_rate: jnp.ndarray
    payer_sign: jnp.ndarray      # +1 payer / -1 receiver
    notional: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_paths", "n_dates"))
def _netting_ee_impl(params, hazard_times, hazard_surv, schedule,
                     strikes, signs, notionals, key, *, n_paths, n_dates):
    from ..solvers.bermudan_hw import _simulate_events, remaining_swap_value

    dtype = schedule.dtype
    hazard = HazardCurve(hazard_times, hazard_surv)
    dates = jnp.arange(n_dates)
    xs, log_ds = _simulate_events(params, schedule, dates, n_paths, key,
                                  dtype)
    ds = jnp.exp(log_ds)

    def net_value(j):
        vals = jnp.stack([
            signs[k] * notionals[k] * remaining_swap_value(
                params, strikes[k], schedule, j, xs[j], payer=True)
            for k in range(strikes.shape[0])
        ])
        return jnp.sum(vals, axis=0)

    ee = jnp.stack([
        jnp.mean(ds[j] * jnp.maximum(net_value(j), 0.0))
        for j in range(n_dates)
    ])
    se = jnp.stack([
        jnp.std(ds[j] * jnp.maximum(net_value(j), 0.0))
        / jnp.sqrt(1.0 * n_paths)
        for j in range(n_dates)
    ])
    q = hazard.q(schedule)
    dq = q[:-1] - q[1:]
    return ee, se, dq[:n_dates]


def cva_netting_hw_mc(
    params: HullWhiteParams,
    hazard: HazardCurve,
    trades: Sequence[SwapTrade],
    schedule,
    key,
    *,
    recovery=0.4,
    n_paths: int = 65536,
):
    """CVA of a netting set of swaps sharing a reset schedule, by
    exact-transition Hull-White MC (EE at each reset date, default
    bucketing as in :func:`cva_swap_hw`).

    Returns ``(cva, ee, ee_se)``.  For a single swap this must agree with
    :func:`cva_swap_hw` to MC error — the test pin.
    """
    schedule = jnp.asarray(schedule)
    dtype = result_dtype(schedule, params.sigma)
    schedule = schedule.astype(dtype)
    n_dates = int(schedule.shape[0]) - 1
    strikes = jnp.stack([jnp.asarray(t.strike_rate, dtype) for t in trades])
    signs = jnp.stack([jnp.asarray(t.payer_sign, dtype) for t in trades])
    notionals = jnp.stack([jnp.asarray(t.notional, dtype) for t in trades])
    ee, se, dq = _netting_ee_impl(
        params, hazard.times.astype(dtype), hazard.survival.astype(dtype),
        schedule, strikes, signs, notionals, key,
        n_paths=n_paths, n_dates=n_dates)
    cva = (1.0 - jnp.asarray(recovery, dtype)) * jnp.sum(ee * dq)
    return cva, ee, se
