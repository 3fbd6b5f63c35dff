"""Profiling and latency instrumentation.

The reference measures latency with Prometheus histograms + time.time deltas
(SURVEY.md section 5, monitoring/metrics.py:448-525); this module adds
device-aware timing (block_until_ready around compiled calls, compile/run
split) and `jax.profiler` trace capture for per-kernel analysis.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

__all__ = ["DeviceTimer", "time_jitted", "trace", "Timings", "device_info"]


def device_info(require: Optional[str] = None) -> Dict[str, Any]:
    """``platform``, ``device_kind`` and ``device_count`` of the default
    backend, for every benchmark row.  With ``require`` set (e.g. "gpu"),
    any other platform is an error: a measurement never falls back."""
    devs = jax.devices()
    if require is not None and devs[0].platform != require:
        raise SystemExit(
            f"no {require} device: JAX found {devs[0].platform!r} "
            f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


@dataclass
class Timings:
    """Compile/run split for a jitted callable."""

    compile_s: float
    median_run_s: float
    runs_s: List[float] = field(default_factory=list)

    @property
    def per_second(self) -> float:
        return 1.0 / self.median_run_s if self.median_run_s > 0 else float("inf")


def time_jitted(fn: Callable, *args, n_runs: int = 10, **kwargs) -> Timings:
    """Time a jitted function with device synchronization.

    The first call (trace + compile + run) is reported separately.  Each of
    the ``n_runs`` steady-state calls is timed on the host clock up to
    ``block_until_ready`` of its output; the median is the per-call figure.
    """
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0

    runs = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        runs.append(time.perf_counter() - t0)
    return Timings(compile_s=compile_s, median_run_s=statistics.median(runs),
                   runs_s=runs)


class DeviceTimer:
    """Accumulating section timer with device sync.

    >>> timer = DeviceTimer()
    >>> with timer("pricing"):
    ...     prices = price_fn(params).block_until_ready()
    >>> timer.report()
    """

    def __init__(self):
        self.sections: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # Fence the device: per-device execution is in-order, so pulling
            # a freshly dispatched trivial computation waits for everything
            # the section enqueued.  (jax.effects_barrier alone only awaits
            # EFFECTFUL computations — pure jitted calls would be missed and
            # the section would record just its dispatch time.)  A device
            # error surfaces here rather than in the next section.
            jax.effects_barrier()
            jax.device_get(jnp.zeros(()))
            self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self.sections.items():
            s = sorted(times)
            out[name] = {
                "n": len(s),
                "total_s": sum(s),
                "median_s": s[len(s) // 2],
                "max_s": s[-1],
            }
        return out


@contextlib.contextmanager
def trace(log_dir: str = "pde_tpu_trace"):
    """Capture a jax.profiler trace (view with TensorBoard/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
