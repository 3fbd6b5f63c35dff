"""Precision policy for pde_tpu.

Two operating modes:

* **parity** (float64/complex128): used by the CPU test-suite to reproduce the
  C++ reference (``/root/reference`` src/cpp) to 1e-8 price / 1e-6 implied-vol
  tolerance.  Requires ``jax_enable_x64`` (the test conftest enables it).
* **speed** (float32/complex64): the device production path.  bfloat16 is used
  only inside selected Pallas kernels; the Carr-Madan quadrature and the
  tridiagonal solves keep float32 accumulation.

Library code never flips global JAX flags; it derives the working dtype from
its inputs via :func:`result_dtype` / :func:`complex_dtype_for` so both modes
work in one build.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "x64_enabled",
    "default_float",
    "complex_dtype_for",
    "result_dtype",
    "EPS",
]


def x64_enabled() -> bool:
    """True when JAX is running with 64-bit types enabled."""
    return bool(jax.config.jax_enable_x64)


def default_float() -> jnp.dtype:
    """Default floating dtype under the current x64 setting."""
    return jnp.dtype(jnp.float64 if x64_enabled() else jnp.float32)


def complex_dtype_for(real_dtype) -> jnp.dtype:
    """Complex dtype matching a real dtype (f64 -> c128, else c64)."""
    if jnp.dtype(real_dtype) == jnp.float64:
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


def result_dtype(*args) -> jnp.dtype:
    """Floating result dtype for a set of inputs (at least default float)."""
    dt = jnp.result_type(*[jnp.asarray(a) for a in args], default_float())
    if not jnp.issubdtype(dt, jnp.floating):
        dt = default_float()
    return jnp.dtype(dt)


def EPS(dtype) -> float:
    """Machine epsilon for a dtype."""
    return float(jnp.finfo(dtype).eps)
