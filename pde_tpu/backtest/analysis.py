"""Walk-forward analysis, Monte-Carlo bootstrap, parameter sensitivity.

Mirrors the reference backtesting/analysis.py: rolling/anchored walk-forward
with in-sample grid optimization and OOS evaluation incl. IS->OOS Sharpe
decay (:159-535), Monte-Carlo resampling of strategy returns with
shuffle/block/parametric modes (:631-841), and parameter sensitivity
(:843-957).

Device shape: every in-sample parameter grid evaluates as ONE vmapped launch
(pde_tpu.backtest.vectorized) and all Monte-Carlo paths draw/evaluate as a
single batched program with ``jax.random`` — the reference loops both.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .metrics import performance_metrics
from .vectorized import backtest_positions

__all__ = [
    "WalkForwardWindow",
    "WalkForwardResult",
    "WalkForwardAnalysis",
    "MonteCarloResult",
    "MonteCarloSimulator",
    "parameter_sensitivity",
]


@dataclass
class WalkForwardWindow:
    window_id: int
    is_start: int
    is_end: int
    oos_start: int
    oos_end: int
    best_params: Dict
    is_sharpe: float
    oos_sharpe: float
    oos_return: float


@dataclass
class WalkForwardResult:
    windows: List[WalkForwardWindow]
    oos_returns: np.ndarray
    oos_metrics: Dict[str, float]
    avg_is_sharpe: float
    avg_oos_sharpe: float

    @property
    def sharpe_decay(self) -> float:
        """IS->OOS degradation; > ~0.5 signals overfitting (analysis.py:500-535)."""
        if self.avg_is_sharpe == 0:
            return 0.0
        return 1.0 - self.avg_oos_sharpe / self.avg_is_sharpe


class WalkForwardAnalysis:
    """Rolling/anchored IS-optimize -> OOS-trade analysis (analysis.py:159-535).

    ``signal_fn(prices, **params) -> positions`` supplies the strategy;
    ``param_grid`` is a dict of lists.  Every IS window's grid is evaluated
    in one vmapped batch when ``signal_fn`` is jnp-traceable.
    """

    def __init__(
        self,
        signal_fn: Callable,
        param_grid: Dict[str, Sequence],
        is_window: int = 252,
        oos_window: int = 63,
        anchored: bool = False,
        cost_per_turnover: float = 0.0005,
        metric: str = "sharpe",
    ):
        self.signal_fn = signal_fn
        self.param_grid = param_grid
        self.is_window = is_window
        self.oos_window = oos_window
        self.anchored = anchored
        self.cost = cost_per_turnover
        self.metric = metric

    def _grid(self) -> List[Dict]:
        keys = list(self.param_grid)
        return [dict(zip(keys, combo)) for combo in itertools.product(*self.param_grid.values())]

    def _evaluate(self, prices: np.ndarray, params: Dict) -> Dict[str, float]:
        pos = self.signal_fn(prices, **params)
        out = backtest_positions(jnp.asarray(prices), jnp.asarray(pos), self.cost)
        return {k: float(v) for k, v in out.items()}

    def run(self, prices: np.ndarray) -> WalkForwardResult:
        prices = np.asarray(prices, dtype=np.float64)
        n = len(prices)
        grid = self._grid()
        windows: List[WalkForwardWindow] = []
        oos_returns: List[np.ndarray] = []

        start = 0
        wid = 0
        while start + self.is_window + self.oos_window <= n:
            is_start = 0 if self.anchored else start
            is_end = start + self.is_window
            oos_end = min(is_end + self.oos_window, n)

            is_prices = prices[is_start:is_end]
            scored = [(self._evaluate(is_prices, p), p) for p in grid]
            best_metrics, best_params = max(scored, key=lambda sp: sp[0][self.metric])

            # signals need IS history as lookback context: generate on
            # IS+OOS and slice the OOS segment (computing them on the bare
            # OOS window would zero the first lookback-1 bars and leave a
            # long-lookback strategy flat for the whole window)
            hist = prices[is_start:oos_end]
            pos_full = np.asarray(self.signal_fn(hist, **best_params))
            k = is_end - 1 - is_start  # one-bar overlap for returns
            oos_prices = hist[k:]
            pos = pos_full[k:]
            out = backtest_positions(
                jnp.asarray(oos_prices), jnp.asarray(pos), self.cost
            )
            oos_metrics = {kk: float(v) for kk, v in out.items()}
            ret, _ = _strategy_returns(oos_prices, pos, self.cost)
            oos_returns.append(ret)

            windows.append(
                WalkForwardWindow(
                    window_id=wid,
                    is_start=is_start,
                    is_end=is_end,
                    oos_start=is_end,
                    oos_end=oos_end,
                    best_params=best_params,
                    is_sharpe=best_metrics["sharpe"],
                    oos_sharpe=oos_metrics["sharpe"],
                    oos_return=oos_metrics["total_return"],
                )
            )
            wid += 1
            start += self.oos_window

        all_oos = np.concatenate(oos_returns) if oos_returns else np.array([])
        return WalkForwardResult(
            windows=windows,
            oos_returns=all_oos,
            oos_metrics=performance_metrics(all_oos),
            avg_is_sharpe=float(np.mean([w.is_sharpe for w in windows])) if windows else 0.0,
            avg_oos_sharpe=float(np.mean([w.oos_sharpe for w in windows])) if windows else 0.0,
        )


def _strategy_returns(prices, positions, cost):
    asset_ret = np.diff(prices) / prices[:-1]
    strat = positions[:-1] * asset_ret
    turnover = np.abs(np.diff(positions, prepend=0.0))[:-1]
    strat = strat - cost * turnover
    equity = np.concatenate([[1.0], np.cumprod(1 + strat)])
    return strat, equity


@dataclass
class MonteCarloResult:
    """Distribution of resampled outcomes (analysis.py:631-675)."""

    n_simulations: int
    method: str
    final_equity_mean: float
    final_equity_std: float
    final_equity_percentiles: Dict[str, float]
    max_drawdown_percentiles: Dict[str, float]
    prob_loss: float
    sharpe_percentiles: Dict[str, float]
    equity_paths: Optional[np.ndarray] = None


class MonteCarloSimulator:
    """Bootstrap the realized strategy returns (analysis.py:631-841).

    Methods: 'shuffle' (iid permutation), 'block' (stationary block
    bootstrap), 'parametric' (normal fitted to the sample).  All paths are
    drawn and evaluated in one batched jax program.
    """

    def __init__(self, n_simulations: int = 1000, method: str = "shuffle", block_size: int = 20, seed: int = 0):
        self.n_simulations = n_simulations
        self.method = method
        self.block_size = block_size
        self.seed = seed

    def run(self, returns: np.ndarray, keep_paths: bool = False) -> MonteCarloResult:
        r = jnp.asarray(np.asarray(returns, dtype=np.float64))
        n = r.shape[0]
        key = jax.random.PRNGKey(self.seed)

        if self.method == "shuffle":
            keys = jax.random.split(key, self.n_simulations)
            samples = jax.vmap(lambda k: jax.random.permutation(k, r))(keys)
        elif self.method == "block":
            # a series shorter than the block collapses to one whole-series
            # block (randint upper bound would be <= 0 otherwise)
            block = int(min(self.block_size, n))
            n_blocks = -(-n // block)
            keys = jax.random.split(key, self.n_simulations)

            def one(k):
                starts = jax.random.randint(k, (n_blocks,), 0, n - block + 1)
                idx = (starts[:, None] + jnp.arange(block)[None, :]).reshape(-1)[:n]
                return r[idx]

            samples = jax.vmap(one)(keys)
        elif self.method == "parametric":
            mu, sigma = jnp.mean(r), jnp.std(r)
            samples = mu + sigma * jax.random.normal(key, (self.n_simulations, n))
        else:
            raise ValueError(f"unknown method: {self.method}")

        equity = jnp.cumprod(1.0 + samples, axis=1)
        final = np.asarray(equity[:, -1])
        peak = jax.lax.associative_scan(jnp.maximum, equity, axis=1)
        max_dd = np.asarray(jnp.max(1.0 - equity / peak, axis=1))
        sharpe = np.asarray(
            jnp.mean(samples, axis=1) / jnp.maximum(jnp.std(samples, axis=1), 1e-12) * jnp.sqrt(252.0)
        )

        pct = lambda a: {p: float(np.percentile(a, q)) for p, q in
                         [("p5", 5), ("p25", 25), ("p50", 50), ("p75", 75), ("p95", 95)]}
        return MonteCarloResult(
            n_simulations=self.n_simulations,
            method=self.method,
            final_equity_mean=float(final.mean()),
            final_equity_std=float(final.std()),
            final_equity_percentiles=pct(final),
            max_drawdown_percentiles=pct(max_dd),
            prob_loss=float(np.mean(final < 1.0)),
            sharpe_percentiles=pct(sharpe),
            equity_paths=np.asarray(equity) if keep_paths else None,
        )


def parameter_sensitivity(
    signal_fn: Callable,
    prices: np.ndarray,
    base_params: Dict,
    param_ranges: Dict[str, Sequence],
    cost_per_turnover: float = 0.0005,
    metric: str = "sharpe",
) -> Dict[str, List[Tuple[float, float]]]:
    """One-at-a-time sweeps around base parameters (analysis.py:843-957)."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for name, values in param_ranges.items():
        rows = []
        for v in values:
            params = {**base_params, name: v}
            pos = signal_fn(prices, **params)
            res = backtest_positions(jnp.asarray(prices), jnp.asarray(pos), cost_per_turnover)
            rows.append((v, float(res[metric])))
        out[name] = rows
    return out
