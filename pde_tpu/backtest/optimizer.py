"""Strategy/parameter optimization: sector fitness search and rolling
re-optimization.

Covers the reference's three optimizer modules in device-native (JAX) form:

* multi_strategy.py:32-434 — the five sub-signal families (momentum, MA
  crossover, mean reversion, RSI, Bollinger) exposed as vectorized position
  generators with named parameter grids;
* sector_optimizer.py:211-773 — per-group strategy x parameter-grid search
  producing fitness scores (JSON-checkpointed, :196-209);
* rolling_optimizer.py:244-610 — optimize on window N, trade window N+1.

The search runs on the array backtester (pde_tpu.backtest.vectorized):
positions for every combo are jitted device programs, dispatched
asynchronously and pulled in ONE transfer per strategy family (the
reference nests Python loops over sectors x strategies x combos x bars and
re-walks the bars in Python each time).  Grid axes that are jnp-traceable
can go further — vectorized.grid_backtest_ma evaluates a whole MA-crossover
grid in a single vmapped launch.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .metrics import performance_metrics
from .vectorized import (
    backtest_positions,
    ma_cross_positions,
    momentum_positions,
    zscore_positions,
)

__all__ = [
    "rsi_positions",
    "bollinger_positions",
    "STRATEGY_FAMILIES",
    "FitnessResult",
    "StrategyOptimizer",
    "RollingOptimizationBacktester",
    "PeriodResult",
    "RollingBacktestResults",
]


# --------------------------------------------------------------------------
# additional signal families (multi_strategy.py:280-434)


def rsi_positions(prices, period: int = 14, oversold: float = 30.0, overbought: float = 70.0):
    """RSI band positions: long below oversold, short above overbought,
    hold otherwise (multi_strategy.py:280-343)."""
    p = jnp.asarray(prices)
    delta = jnp.diff(p, prepend=p[0])
    gain = jnp.maximum(delta, 0.0)
    loss = jnp.maximum(-delta, 0.0)

    alpha = 1.0 / period

    def ema_step(s, x):
        s = (1 - alpha) * s + alpha * x
        return s, s

    _, avg_gain = jax.lax.scan(ema_step, jnp.asarray(0.0, p.dtype), gain)
    _, avg_loss = jax.lax.scan(ema_step, jnp.asarray(0.0, p.dtype), loss)
    rs = avg_gain / jnp.maximum(avg_loss, 1e-12)
    rsi = 100.0 - 100.0 / (1.0 + rs)

    warm = jnp.arange(p.shape[0]) < period

    def pos_step(state, x):
        r, w = x
        new = jnp.where(r < oversold, 1.0, jnp.where(r > overbought, -1.0, state))
        new = jnp.where(w, 0.0, new)
        return new, new

    _, pos = jax.lax.scan(pos_step, jnp.asarray(0.0, p.dtype), (rsi, warm))
    return pos


def bollinger_positions(prices, window: int = 20, n_std: float = 2.0):
    """Bollinger band mean reversion: long under the lower band, short over
    the upper, flat at the middle (multi_strategy.py:344-434)."""
    p = jnp.asarray(prices)
    n = p.shape[0]
    idx = jnp.arange(n)
    csum = jnp.cumsum(p)
    csum2 = jnp.cumsum(p * p)
    wsum = csum - jnp.where(idx >= window, csum[jnp.maximum(idx - window, 0)], 0.0)
    wsum2 = csum2 - jnp.where(idx >= window, csum2[jnp.maximum(idx - window, 0)], 0.0)
    count = jnp.minimum(idx + 1, window)
    mean = wsum / count
    var = jnp.maximum(wsum2 / count - mean * mean, 0.0)
    std = jnp.sqrt(var)
    upper = mean + n_std * std
    lower = mean - n_std * std
    warm = idx < window - 1

    def step(state, x):
        pi, up, lo, mid, w = x
        new = jnp.where(pi < lo, 1.0, state)
        new = jnp.where(pi > up, -1.0, new)
        crossed_mid = ((state == 1.0) & (pi >= mid)) | ((state == -1.0) & (pi <= mid))
        new = jnp.where(crossed_mid, 0.0, new)
        return jnp.where(w, 0.0, new), jnp.where(w, 0.0, new)

    _, pos = jax.lax.scan(step, jnp.asarray(0.0, p.dtype), (p, upper, lower, mean, warm))
    return pos


# strategy families with default parameter grids (multi_strategy.py semantics)
STRATEGY_FAMILIES: Dict[str, Dict[str, Any]] = {
    "momentum": {
        "fn": lambda p, lookback, holding: momentum_positions(p, lookback, holding),
        "grid": {"lookback": [20, 40, 60], "holding": [5, 10, 20]},
    },
    "ma_crossover": {
        "fn": lambda p, short, long: ma_cross_positions(p, short, long),
        "grid": {"short": [5, 10, 20], "long": [40, 60, 100]},
    },
    "mean_reversion": {
        "fn": lambda p, lookback, entry_z, exit_z: zscore_positions(p, lookback, entry_z, exit_z),
        "grid": {"lookback": [15, 20, 30], "entry_z": [1.5, 2.0, 2.5], "exit_z": [0.5]},
    },
    "rsi": {
        "fn": lambda p, period, oversold, overbought: rsi_positions(p, period, oversold, overbought),
        "grid": {"period": [7, 14, 21], "oversold": [25.0, 30.0], "overbought": [70.0, 75.0]},
    },
    "bollinger": {
        "fn": lambda p, window, n_std: bollinger_positions(p, window, n_std),
        "grid": {"window": [15, 20, 30], "n_std": [1.5, 2.0, 2.5]},
    },
}


@dataclass
class FitnessResult:
    """Best configuration for one (group, strategy) cell
    (sector_optimizer.py:87-124)."""

    group: str
    strategy: str
    params: Dict[str, Any]
    fitness: float
    sharpe: float
    total_return: float
    max_drawdown: float

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class StrategyOptimizer:
    """Per-group strategy x parameter-grid search with JSON checkpoints.

    The reference's SectorAlgorithmOptimizer (sector_optimizer.py:211-773)
    generalized: groups are any {name: {symbol: prices}} partition (sectors,
    industries, single names).  Fitness = sharpe - drawdown_penalty * max_dd
    (the reference's fitness combines the same ingredients).
    """

    def __init__(
        self,
        strategies: Optional[Dict[str, Dict]] = None,
        cost_per_turnover: float = 0.0005,
        drawdown_penalty: float = 1.0,
        cache_path: Optional[str] = None,
    ):
        self.strategies = strategies or STRATEGY_FAMILIES
        self.cost = cost_per_turnover
        self.drawdown_penalty = drawdown_penalty
        self.cache_path = Path(cache_path) if cache_path else None

    def optimize_series(self, prices: np.ndarray, group: str = "default") -> Dict[str, FitnessResult]:
        """Search every strategy family's grid on one price series."""
        p = jnp.asarray(np.asarray(prices, dtype=np.float64))
        out: Dict[str, FitnessResult] = {}
        for name, spec in self.strategies.items():
            keys = list(spec["grid"])
            combos = list(itertools.product(*spec["grid"].values()))
            # dispatch every combo asynchronously; ONE device pull at the end
            # (per-combo float() syncs would serialize the grid on transfer
            # latency)
            evals = [
                (dict(zip(keys, combo)),
                 backtest_positions(p, spec["fn"](p, **dict(zip(keys, combo))),
                                    self.cost))
                for combo in combos
            ]
            results = jax.device_get([r for _, r in evals])
            best = None
            for (params, _), res in zip(evals, results):
                sharpe = float(res["sharpe"])
                dd = float(res["max_drawdown"])
                fitness = sharpe - self.drawdown_penalty * dd
                if best is None or fitness > best.fitness:
                    best = FitnessResult(
                        group=group,
                        strategy=name,
                        params=params,
                        fitness=fitness,
                        sharpe=sharpe,
                        total_return=float(res["total_return"]),
                        max_drawdown=dd,
                    )
            out[name] = best
        return out

    def run_optimization(self, groups: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, FitnessResult]]:
        """groups: {group_name: {symbol: prices}}.  Per-group results are
        averaged over the group's symbols, then checkpointed."""
        results: Dict[str, Dict[str, FitnessResult]] = {}
        for group, members in groups.items():
            per_strategy: Dict[str, List[FitnessResult]] = {}
            for symbol, prices in members.items():
                for name, fr in self.optimize_series(prices, group).items():
                    per_strategy.setdefault(name, []).append(fr)
            merged = {}
            for name, frs in per_strategy.items():
                best = max(frs, key=lambda f: f.fitness)
                avg_fitness = float(np.mean([f.fitness for f in frs]))
                merged[name] = FitnessResult(
                    group=group,
                    strategy=name,
                    params=best.params,
                    fitness=avg_fitness,
                    sharpe=float(np.mean([f.sharpe for f in frs])),
                    total_return=float(np.mean([f.total_return for f in frs])),
                    max_drawdown=float(np.mean([f.max_drawdown for f in frs])),
                )
            results[group] = merged
        if self.cache_path:
            self.save(results, self.cache_path)
        return results

    def get_best_strategy(self, results: Dict[str, Dict[str, FitnessResult]], group: str) -> FitnessResult:
        return max(results[group].values(), key=lambda f: f.fitness)

    @staticmethod
    def save(results: Dict[str, Dict[str, FitnessResult]], path) -> None:
        payload = {
            g: {s: fr.to_dict() for s, fr in cells.items()} for g, cells in results.items()
        }
        Path(path).write_text(json.dumps(payload, indent=1))

    @staticmethod
    def load(path) -> Dict[str, Dict[str, FitnessResult]]:
        payload = json.loads(Path(path).read_text())
        return {
            g: {s: FitnessResult(**fr) for s, fr in cells.items()}
            for g, cells in payload.items()
        }


@dataclass
class PeriodResult:
    """One optimize->trade period (rolling_optimizer.py:56-98)."""

    period_id: int
    opt_start: int
    opt_end: int
    trade_start: int
    trade_end: int
    chosen_strategy: str
    chosen_params: Dict[str, Any]
    period_return: float
    period_sharpe: float


@dataclass
class RollingBacktestResults:
    """Aggregate of all periods (rolling_optimizer.py:99-243)."""

    periods: List[PeriodResult] = field(default_factory=list)
    oos_returns: np.ndarray = field(default_factory=lambda: np.array([]))
    aggregate_metrics: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        m = self.aggregate_metrics
        return (
            f"Rolling backtest: {len(self.periods)} periods, "
            f"total {m.get('total_return_pct', 0):.2f}%, "
            f"sharpe {m.get('sharpe_ratio', 0):.2f}, "
            f"max dd {m.get('max_drawdown_pct', 0):.2f}%"
        )


class RollingOptimizationBacktester:
    """Optimize on window N, trade window N+1 (rolling_optimizer.py:244-610)."""

    def __init__(
        self,
        optimizer: Optional[StrategyOptimizer] = None,
        opt_window: int = 252,
        trade_window: int = 63,
        cost_per_turnover: float = 0.0005,
    ):
        self.optimizer = optimizer or StrategyOptimizer()
        self.opt_window = opt_window
        self.trade_window = trade_window
        self.cost = cost_per_turnover

    def run(self, prices: np.ndarray) -> RollingBacktestResults:
        prices = np.asarray(prices, dtype=np.float64)
        n = len(prices)
        periods: List[PeriodResult] = []
        oos: List[np.ndarray] = []

        start, pid = 0, 0
        while start + self.opt_window + self.trade_window <= n:
            opt_end = start + self.opt_window
            trade_end = min(opt_end + self.trade_window, n)

            fits = self.optimizer.optimize_series(prices[start:opt_end])
            best = max(fits.values(), key=lambda f: f.fitness)

            # generate signals with the optimization window as lookback
            # context, then trade only the out-of-sample slice (signals on
            # the bare trade window would stay flat until the lookback fills)
            spec = self.optimizer.strategies[best.strategy]
            hist = prices[start:trade_end]
            pos_full = np.asarray(spec["fn"](jnp.asarray(hist), **best.params))
            k = opt_end - 1 - start
            trade_prices = hist[k:]
            pos = jnp.asarray(pos_full[k:])
            res = backtest_positions(jnp.asarray(trade_prices), pos, self.cost)

            from .analysis import _strategy_returns

            strat_ret, _ = _strategy_returns(trade_prices, pos_full[k:], self.cost)
            oos.append(strat_ret)

            periods.append(
                PeriodResult(
                    period_id=pid,
                    opt_start=start,
                    opt_end=opt_end,
                    trade_start=opt_end,
                    trade_end=trade_end,
                    chosen_strategy=best.strategy,
                    chosen_params=best.params,
                    period_return=float(res["total_return"]),
                    period_sharpe=float(res["sharpe"]),
                )
            )
            pid += 1
            start += self.trade_window

        all_oos = np.concatenate(oos) if oos else np.array([])
        return RollingBacktestResults(
            periods=periods,
            oos_returns=all_oos,
            aggregate_metrics=performance_metrics(all_oos),
        )
