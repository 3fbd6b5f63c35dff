"""Matrix utilities for risk and portfolio analytics.

JAX equivalents of the reference's Eigen helpers
(src/cpp/core/matrix_utils.hpp:42-318): covariance/correlation estimation,
positive-definiteness repair, Cholesky, safe inversion and EWMA covariance.
All functions are pure jnp and differentiable where meaningful.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "compute_covariance",
    "covariance_to_correlation",
    "condition_number",
    "is_positive_definite",
    "safe_invert",
    "cholesky_decomposition",
    "make_positive_definite",
    "solve_positive_definite",
    "ewma_covariance",
]


def compute_covariance(returns: jnp.ndarray, ddof: int = 1) -> jnp.ndarray:
    """Sample covariance of a (n_obs, n_assets) return matrix.

    Reference: compute_covariance (src/cpp/core/matrix_utils.hpp:42).
    """
    x = returns - jnp.mean(returns, axis=0, keepdims=True)
    n = returns.shape[0]
    return (x.T @ x) / (n - ddof)


def covariance_to_correlation(cov: jnp.ndarray) -> jnp.ndarray:
    """Convert a covariance matrix to a correlation matrix.

    Reference: covariance_to_correlation (src/cpp/core/matrix_utils.hpp:76).
    """
    d = jnp.sqrt(jnp.clip(jnp.diag(cov), 1e-300, None))
    corr = cov / jnp.outer(d, d)
    # force exact unit diagonal
    n = cov.shape[0]
    return corr.at[jnp.arange(n), jnp.arange(n)].set(1.0)


def condition_number(a: jnp.ndarray) -> jnp.ndarray:
    """2-norm condition number via singular values.

    Reference: condition_number (src/cpp/core/matrix_utils.hpp:139).
    """
    s = jnp.linalg.svd(a, compute_uv=False)
    return s[0] / jnp.clip(s[-1], 1e-300, None)


def is_positive_definite(a: jnp.ndarray, tol: float = 0.0) -> jnp.ndarray:
    """True when all eigenvalues of the symmetric matrix exceed ``tol``.

    Reference: is_positive_definite (src/cpp/core/matrix_utils.hpp:165).
    """
    w = jnp.linalg.eigvalsh(0.5 * (a + a.T))
    return jnp.all(w > tol)


def safe_invert(a: jnp.ndarray, ridge: float = 1e-10) -> jnp.ndarray:
    """Inverse with a small ridge on the diagonal for numerical safety.

    Reference: safe_invert (src/cpp/core/matrix_utils.hpp:187).
    """
    n = a.shape[0]
    return jnp.linalg.inv(a + ridge * jnp.eye(n, dtype=a.dtype))


def cholesky_decomposition(a: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular Cholesky factor.

    Reference: cholesky_decomposition (src/cpp/core/matrix_utils.hpp:208).
    """
    return jnp.linalg.cholesky(a)


def make_positive_definite(a: jnp.ndarray, min_eigenvalue: float = 1e-8) -> jnp.ndarray:
    """Repair a symmetric matrix to be positive definite.

    Clips eigenvalues from below at ``min_eigenvalue`` and reconstructs —
    the spectral repair used by the reference
    (make_positive_definite, src/cpp/core/matrix_utils.hpp:231).
    """
    sym = 0.5 * (a + a.T)
    w, v = jnp.linalg.eigh(sym)
    w = jnp.clip(w, min_eigenvalue, None)
    return (v * w) @ v.T


def solve_positive_definite(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for SPD A via Cholesky.

    Reference: solve_positive_definite (src/cpp/core/matrix_utils.hpp:269).
    """
    c = jnp.linalg.cholesky(a)
    y = jax.scipy.linalg.solve_triangular(c, b, lower=True)
    return jax.scipy.linalg.solve_triangular(c.T, y, lower=False)


def ewma_covariance(returns: jnp.ndarray, lam: float = 0.94) -> jnp.ndarray:
    """Exponentially-weighted covariance (RiskMetrics lambda=0.94 default).

    JAX formulation of ewma_covariance
    (src/cpp/core/matrix_utils.hpp:287): a ``lax.scan`` over observations,
    Sigma_t = lam * Sigma_{t-1} + (1 - lam) * r_t r_t^T.
    """
    x = returns - jnp.mean(returns, axis=0, keepdims=True)
    n_assets = x.shape[1]
    init = compute_covariance(returns)

    def step(sigma, r):
        sigma = lam * sigma + (1.0 - lam) * jnp.outer(r, r)
        return sigma, None

    sigma, _ = jax.lax.scan(step, init, x)
    del n_assets
    return sigma
