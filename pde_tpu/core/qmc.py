"""Quasi-Monte Carlo on device: Sobol' points generated with XOR bit-scans.

The reference platform's only Monte Carlo engines are pseudo-random
(backtesting/analysis.py:631-841 bootstrap, risk/var_calculator.py:241-505
VaR simulator); it has no low-discrepancy sampling at all.  This module adds
randomized quasi-Monte Carlo as a first-class sampling mode for the path
pricers (:mod:`pde_tpu.models.heston_mc`), cutting the error of smooth path
integrands from the O(N^-1/2) Monte Carlo rate toward the O(N^-1 log^d N)
QMC rate at identical path counts.

Device-native design
-----------------
Direction numbers are a tiny host-side table (``(dim, 32)`` uint32, from
scipy's Joe-Kuo data, fetched once per dimension and cached).  Everything
else runs on device as integer vector work:

* **point generation** — the Gray-code construction ``x_i = XOR of V[:,k]
  over set bits k of gray(i)`` is a 32-iteration ``lax.scan`` of masked XORs
  over the whole ``(n_points, dim)`` block at once; no sequential recurrence
  over points, so generation vectorizes perfectly and composes with the path
  axis of the MC engines.
* **randomization** — Matousek linear matrix scrambling (random nonsingular
  lower-triangular bit matrix per dimension, applied to the direction
  numbers with ``lax.population_count`` parities) plus a digital shift, both
  jittable and keyed by a JAX PRNG key.  LMS + shift preserves the digital
  (t,m,s)-net structure, so every randomization keeps the QMC convergence
  rate while making the estimator unbiased; independent keys give the
  independent replicates used for error estimation.

Points are mapped to (0,1) at the *center* of the 2^-24 (f32) / 2^-53 (f64)
cell so downstream ``ndtri`` calls never see 0 or 1.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .precision import default_float

__all__ = [
    "HAVE_DIRECTION_NUMBERS",
    "sobol_direction_numbers",
    "scramble_direction_numbers",
    "sobol_uint32",
    "sobol_uint32_from_gray",
    "gray_codes",
    "to_unit",
    "sobol_uniform",
    "sobol_normal",
]

_NBITS = 32

try:  # direction-number source: scipy's Joe-Kuo table (host-side, once)
    from scipy.stats import qmc as _scipy_qmc

    HAVE_DIRECTION_NUMBERS = True
except Exception:  # pragma: no cover - scipy is in the base image
    _scipy_qmc = None
    HAVE_DIRECTION_NUMBERS = False


@functools.lru_cache(maxsize=None)
def _direction_numbers_cached(dim: int):
    sob = _scipy_qmc.Sobol(d=dim, scramble=False, bits=_NBITS)
    return np.ascontiguousarray(np.asarray(sob._sv, dtype=np.uint32))


def sobol_direction_numbers(dim: int) -> np.ndarray:
    """Host-side ``(dim, 32)`` uint32 Sobol' direction numbers (MSB-first).

    Convention: the i-th point is ``XOR over set bits k of gray(i) of
    ``V[:, k]`` and maps to (0,1) as ``x * 2**-32`` — the same layout scipy's
    generator uses internally, validated against it in tests/test_qmc.py.
    """
    if not HAVE_DIRECTION_NUMBERS:  # pragma: no cover
        raise RuntimeError(
            "Sobol direction numbers need scipy.stats.qmc; scipy is "
            "unavailable in this environment"
        )
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    return _direction_numbers_cached(int(dim))


def scramble_direction_numbers(dv, key):
    """Matousek linear-matrix scramble of a direction-number block (jittable).

    Each dimension's digits are transformed by an independent random
    nonsingular lower-triangular 32x32 bit matrix L (unit diagonal, strictly
    lower entries uniform):  output digit ``i`` of every direction number is
    the GF(2) inner product of row ``L_i`` with the input digits.  Digits are
    MSB-first, so row ``i`` occupies bit positions 31 .. 31-i with the
    diagonal at position ``31-i``.

    Returns the scrambled ``(dim, 32)`` uint32 block.  Combine with a digital
    shift (done by :func:`sobol_uint32`) for unbiased randomized QMC.
    """
    dv = jnp.asarray(dv, jnp.uint32)
    dim = dv.shape[0]
    rows = jax.random.bits(key, (dim, _NBITS), dtype=jnp.uint32)
    i = jnp.arange(_NBITS, dtype=jnp.uint32)
    diag = jnp.uint32(1) << (jnp.uint32(31) - i)
    # bits strictly above the diagonal position (columns 0..i-1) are random;
    # i == 0 has none (a shift by 32 is undefined, so mask it explicitly)
    above = jnp.where(
        i == 0,
        jnp.uint32(0),
        jnp.uint32(0xFFFFFFFF) << (jnp.uint32(_NBITS) - i),
    )
    m = (rows & above[None, :]) | diag[None, :]  # (dim, 32) row masks
    par = lax.population_count(m[:, :, None] & dv[:, None, :]) & jnp.uint32(1)
    # row i writes bit (31 - i); rows hit disjoint bits so a sum assembles
    # the word without carries
    return jnp.sum(par << (jnp.uint32(31) - i)[None, :, None], axis=1)


def sobol_uint32_from_gray(g, dv, shift=None):
    """Sobol integers for precomputed Gray codes ``g`` (jittable).

    ``g``: (n,) uint32 Gray codes (``i ^ (i >> 1)``), ``dv``: (dim, 32)
    uint32, ``shift``: optional (dim,) uint32 digital shift.  Returns
    (n, dim) uint32.  The scan runs over the 32 bit positions, XORing each
    direction number into the points whose Gray code has that bit set —
    O(32) fused masked-XOR passes over the whole block, no per-point
    recurrence.  Exposed separately so time-stepping scans (one dimension
    pair per step) can hoist the Gray codes and feed per-step ``dv`` slices.
    """
    dv = jnp.asarray(dv, jnp.uint32)

    def body(x, inp):
        k, vk = inp
        take = ((g >> k) & 1).astype(bool)
        return jnp.where(take[:, None], x ^ vk[None, :], x), None

    x0 = jnp.zeros((g.shape[0], dv.shape[0]), jnp.uint32)
    ks = jnp.arange(_NBITS, dtype=jnp.uint32)
    x, _ = lax.scan(body, x0, (ks, dv.T))
    if shift is not None:
        x = x ^ jnp.asarray(shift, jnp.uint32)[None, :]
    return x


def gray_codes(n: int, index_offset=0):
    """(n,) uint32 Gray codes of the point indices starting at offset."""
    i = jnp.arange(n, dtype=jnp.uint32) + jnp.asarray(index_offset, jnp.uint32)
    return i ^ (i >> 1)


def _sobol_raw(dv, n: int, index_offset):
    return sobol_uint32_from_gray(gray_codes(n, index_offset), dv)


def sobol_uint32(dv, n: int, key=None, *, index_offset=0):
    """(n, dim) uint32 Sobol integers; ``key`` adds a digital shift.

    With a key the sequence is randomized (XOR with one uniform word per
    dimension) — combine with :func:`scramble_direction_numbers` for full
    Matousek LMS+shift randomization.
    """
    x = _sobol_raw(dv, n, index_offset)
    if key is not None:
        shift = jax.random.bits(key, (x.shape[1],), dtype=jnp.uint32)
        x = x ^ shift[None, :]
    return x


def to_unit(x, dtype):
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        return x.astype(jnp.float64) * jnp.float64(2.0**-32) + jnp.float64(
            2.0**-33
        )
    # keep 24 significant bits so every cell center is exactly representable
    return (x >> jnp.uint32(8)).astype(dtype) * dtype.type(2.0**-24) + dtype.type(
        2.0**-25
    )


def sobol_uniform(dv, n: int, key=None, *, index_offset=0, dtype=None):
    """(n, dim) Sobol points in the open interval (0, 1)."""
    dtype = default_float() if dtype is None else dtype
    return to_unit(sobol_uint32(dv, n, key, index_offset=index_offset), dtype)


def sobol_normal(dv, n: int, key=None, *, index_offset=0, dtype=None):
    """(n, dim) standard-normal Sobol points via the inverse CDF."""
    u = sobol_uniform(dv, n, key, index_offset=index_offset, dtype=dtype)
    return jax.scipy.special.ndtri(u)
