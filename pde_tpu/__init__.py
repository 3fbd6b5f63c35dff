"""pde_tpu — a JAX quantitative pricing and trading framework.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
C++/Python platform (dharvpat/PDE): stochastic-volatility pricing (Heston,
SABR), finite-difference PDE solvers (Crank-Nicolson, Craig-Sneyd ADI, HJB
optimal stopping), OU mean-reversion fitting, batched surface calibration,
and the strategy/risk/backtest/execution/data stack above them.

Compute-path design: parameters are pytrees, pricers are pure broadcasting
functions, solvers are ``lax.scan`` over time with batched tridiagonal
kernels (fused Pallas march kernels for option books on a GPU),
calibration is a jitted vmapped optimizer over whole surfaces, and
multi-device scaling uses ``jax.sharding`` meshes (quote-axis
data-parallel, grid-axis sharding for PDEs).

The compute core always imports; only the subpackages whose optional
dependencies (pandas, requests, aiohttp, prometheus_client, a database
driver) may be missing are guarded, mirroring the reference's
optional-import lattice (src/python/quant_trading/__init__.py:34-96).
"""

__version__ = "0.1.0"

from . import core, utils  # noqa: F401  (always available)

from . import (  # noqa: F401,E402  (the compute core: never optional)
    models, ops, solvers, calibrate, parallel, signals, risk, backtest,
    validation, execution, serving, trading_system,
)
# NOT cli: `python -m pde_tpu.cli` would find it pre-imported by the
# package and emit a runpy double-import warning; import it explicitly

for _name in ("data", "database", "monitoring"):
    try:
        __import__(f"{__name__}.{_name}")
    except ImportError:  # pragma: no cover - optional dependencies missing
        pass
del _name
