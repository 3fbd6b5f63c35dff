"""Backtesting: event-driven engine + vectorized device fast path + analysis."""

from . import analysis, data_handler, engine, events, execution, metrics, portfolio, strategy, vectorized  # noqa: F401
from .data_handler import ArrayDataHandler, SyntheticDataHandler  # noqa: F401
from .engine import BacktestEngine, BacktestResults  # noqa: F401
from .portfolio import Portfolio  # noqa: F401
from . import optimizer, sectors  # noqa: F401
