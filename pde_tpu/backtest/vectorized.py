"""Vectorized array backtester — the device fast path.

The reference's strategy math (z-scores, moving averages, momentum) runs
per-bar inside the event loop; here the equivalent computation is a pure
array program:

    position_t (from a signal array) ->
    r_t = position_{t-1} * (p_t / p_{t-1} - 1) - cost_per_turnover * |dpos_t|

so one jitted call evaluates a full backtest, ``vmap`` evaluates an entire
parameter grid, and the walk-forward / sector / rolling optimizers
(pde_tpu.backtest.analysis, .optimizer) run their whole searches in a few
device launches instead of the reference's nested Python loops
(backtesting/analysis.py:159-535, sector_optimizer.py:211-773).

Signal generators used here live as ``signal_array`` staticmethods on the
strategies, plus jnp implementations of MA-cross and z-score below for
on-device grids.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "equity_from_positions",
    "backtest_positions",
    "ma_cross_positions",
    "zscore_positions",
    "momentum_positions",
    "grid_backtest_ma",
]


def equity_from_positions(prices, positions, cost_per_turnover: float = 0.0):
    """Per-bar strategy returns from a position series.

    positions[t] is the position HELD FROM bar t to t+1 (signal known at t).
    Returns (returns, equity) with equity normalized to 1.0.
    """
    prices = jnp.asarray(prices)
    positions = jnp.asarray(positions)
    asset_ret = prices[1:] / prices[:-1] - 1.0
    strat_ret = positions[:-1] * asset_ret
    turnover = jnp.abs(jnp.diff(positions, prepend=0.0))[:-1]
    strat_ret = strat_ret - cost_per_turnover * turnover
    equity = jnp.concatenate([jnp.ones(1), jnp.cumprod(1.0 + strat_ret)])
    return strat_ret, equity


def backtest_positions(prices, positions, cost_per_turnover: float = 0.0) -> Dict[str, jnp.ndarray]:
    """Jit-friendly scalar metrics for one (prices, positions) pair."""
    ret, equity = equity_from_positions(prices, positions, cost_per_turnover)
    n = ret.shape[0]
    ann = 252.0
    mean = jnp.mean(ret)
    std = jnp.std(ret)
    sharpe = jnp.where(std > 0, mean / std * jnp.sqrt(ann), 0.0)
    peak = jax.lax.associative_scan(jnp.maximum, equity)
    max_dd = jnp.max(1.0 - equity / peak)
    total = equity[-1] - 1.0
    return {
        "total_return": total,
        "annualized_return": (1.0 + total) ** (ann / jnp.maximum(n, 1)) - 1.0,
        "sharpe": sharpe,
        "max_drawdown": max_dd,
        "final_equity": equity[-1],
    }


def _moving_average(prices, window: int):
    """Trailing SMA via cumulative sums; first window-1 entries use the
    expanding mean (only used past warmup anyway)."""
    p = jnp.asarray(prices)
    csum = jnp.cumsum(p)
    idx = jnp.arange(p.shape[0])
    wsum = csum - jnp.where(idx >= window, csum[jnp.maximum(idx - window, 0)], 0.0)
    count = jnp.minimum(idx + 1, window)
    return wsum / count


def ma_cross_positions(prices, short_window: int, long_window: int):
    """+1/-1 position from an SMA crossover, 0 during warmup (jnp)."""
    p = jnp.asarray(prices)
    short = _moving_average(p, short_window)
    long_ = _moving_average(p, long_window)
    sig = jnp.where(short > long_, 1.0, -1.0)
    warm = jnp.arange(p.shape[0]) < (long_window - 1)
    return jnp.where(warm, 0.0, sig)


def zscore_positions(prices, lookback: int, entry_z: float, exit_z: float):
    """Stateful z-score band walk as a lax.scan (strategy.py:259-373)."""
    p = jnp.asarray(prices)
    n = p.shape[0]
    mean = _moving_average(p, lookback)
    # rolling second moment for std
    p2_mean = _moving_average(p * p, lookback)
    var = jnp.maximum(p2_mean - mean * mean, 0.0)
    # ddof correction approximating the event-driven implementation
    count = jnp.minimum(jnp.arange(n) + 1, lookback)
    std = jnp.sqrt(var * count / jnp.maximum(count - 1, 1))
    z = jnp.where(std > 0, (p - mean) / jnp.where(std > 0, std, 1.0), 0.0)
    warm = jnp.arange(n) < (lookback - 1)
    z = jnp.where(warm, 0.0, z)

    def step(state, zi):
        enter_long = (state == 0) & (zi < -entry_z)
        enter_short = (state == 0) & (zi > entry_z)
        exit_long = (state == 1) & (zi >= -exit_z)
        exit_short = (state == -1) & (zi <= exit_z)
        new = jnp.where(enter_long, 1, state)
        new = jnp.where(enter_short, -1, new)
        new = jnp.where(exit_long | exit_short, 0, new)
        return new, new

    _, pos = jax.lax.scan(step, jnp.asarray(0), z)
    return pos.astype(p.dtype)


def momentum_positions(prices, lookback: int, holding_period: int):
    """Rebalance every holding_period bars on trailing-return sign (jnp)."""
    p = jnp.asarray(prices)
    n = p.shape[0]
    idx = jnp.arange(n)
    mom = jnp.where(idx >= lookback, p / p[jnp.maximum(idx - lookback, 0)] - 1.0, 0.0)
    rebalance = (idx >= lookback) & ((idx - lookback) % holding_period == 0)

    def step(state, x):
        mi, rb = x
        new = jnp.where(rb, jnp.where(mi > 0, 1.0, -1.0), state)
        return new, new

    _, pos = jax.lax.scan(step, jnp.asarray(0.0, dtype=p.dtype), (mom, rebalance))
    return pos


@partial(jax.jit, static_argnames=("cost_per_turnover",))
def grid_backtest_ma(prices, short_windows, long_windows, cost_per_turnover: float = 0.0005):
    """Backtest an entire MA-crossover parameter grid in ONE device launch.

    short_windows/long_windows: (G,) int arrays (pairs).  Windows enter as
    data (comparisons against index arrays), so the grid is a vmapped batch,
    not G recompilations.
    """
    p = jnp.asarray(prices)
    n = p.shape[0]
    idx = jnp.arange(n)
    csum = jnp.cumsum(p)

    def ma(window):
        wsum = csum - jnp.where(idx >= window, csum[jnp.maximum(idx - window, 0)], 0.0)
        count = jnp.minimum(idx + 1, window)
        return wsum / count

    def one(sw, lw):
        sig = jnp.where(ma(sw) > ma(lw), 1.0, -1.0)
        sig = jnp.where(idx < lw - 1, 0.0, sig)
        out = backtest_positions(p, sig, cost_per_turnover)
        return out["sharpe"], out["total_return"], out["max_drawdown"]

    sharpes, totals, dds = jax.vmap(one)(jnp.asarray(short_windows), jnp.asarray(long_windows))
    return {"sharpe": sharpes, "total_return": totals, "max_drawdown": dds}
