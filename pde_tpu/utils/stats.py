"""Scalar/vector statistical primitives.

JAX equivalents of the reference math utils
(src/cpp/core/math_utils.hpp:26-56): mean/variance/std and the standard
normal CDF/PDF, all vectorized jnp functions.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.special import erf

__all__ = ["mean", "variance", "std_dev", "norm_cdf", "norm_pdf"]

_INV_SQRT_2PI = 0.3989422804014327


def mean(x: jnp.ndarray, axis=None) -> jnp.ndarray:
    return jnp.mean(x, axis=axis)


def variance(x: jnp.ndarray, axis=None, ddof: int = 1) -> jnp.ndarray:
    """Sample variance (ddof=1 by default, matching the reference)."""
    return jnp.var(x, axis=axis, ddof=ddof)


def std_dev(x: jnp.ndarray, axis=None, ddof: int = 1) -> jnp.ndarray:
    return jnp.std(x, axis=axis, ddof=ddof)


def norm_cdf(x) -> jnp.ndarray:
    """Standard normal CDF: 0.5 * (1 + erf(x / sqrt(2)))."""
    x = jnp.asarray(x)
    return 0.5 * (1.0 + erf(x / jnp.sqrt(jnp.asarray(2.0, dtype=x.dtype))))


def norm_pdf(x) -> jnp.ndarray:
    """Standard normal PDF."""
    x = jnp.asarray(x)
    return _INV_SQRT_2PI * jnp.exp(-0.5 * x * x)
