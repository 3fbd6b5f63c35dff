"""Profiling harness tests."""

import jax
import jax.numpy as jnp

from pde_tpu.utils.profiling import DeviceTimer, time_jitted


def test_time_jitted_compile_run_split():
    @jax.jit
    def f(x):
        return (x * x).sum()

    t = time_jitted(f, jnp.arange(1024.0), n_runs=5)
    assert t.compile_s > 0
    assert t.median_run_s > 0
    assert len(t.runs_s) >= 1
    assert t.compile_s >= t.median_run_s  # first call includes tracing


def test_device_timer_sections():
    timer = DeviceTimer()
    for _ in range(3):
        with timer("work"):
            jnp.ones(128).sum().block_until_ready()
    rep = timer.report()
    assert rep["work"]["n"] == 3
    assert rep["work"]["total_s"] >= rep["work"]["median_s"]


def test_time_jitted_times_every_run():
    calls = []

    @jax.jit
    def f(x):
        return x + 1.0

    def counted(x):
        calls.append(1)
        return f(x)

    t = time_jitted(counted, jnp.ones(8), n_runs=4)
    assert len(calls) == 5          # one warm-up + four timed runs
    assert len(t.runs_s) == 4
    assert sorted(t.runs_s)[1] <= t.median_run_s <= sorted(t.runs_s)[2]


def test_device_timer_does_not_swallow_device_errors(monkeypatch):
    """A failure while fencing the device propagates out of the section."""
    import pytest

    def broken(_):
        raise RuntimeError("device lost")

    monkeypatch.setattr(jax, "device_get", broken)
    timer = DeviceTimer()
    with pytest.raises(RuntimeError, match="device lost"):
        with timer("work"):
            pass
