"""Term-structure Heston: piecewise-constant parameters via Riccati gluing.

Real desks calibrate one Heston model across a maturity strip, which a
single constant parameter set cannot fit; the standard cure (Mikhailov &
Noegel 2003) lets (kappa, theta, sigma, rho) be piecewise constant in time
and glues the Riccati ODE solutions across the intervals: solving backward
from maturity, the ``D`` exponent at the start of interval ``j`` becomes the
terminal condition of interval ``j-1``, for which the constant-parameter
Riccati still has a closed form.

Device-first integration: :class:`TermHestonParams` is a pytree whose
``cf_reduced_extra`` hook (models/heston.py:_cf_reduced) *divides out* the
base constant-parameter exponents and multiplies the glued ones in — so the
whole existing pricing stack (Carr-Madan quadrature, corrected-GL rules,
FFT strike grids, implied vol, AD greeks) prices the term-structure model
unchanged.  The interval loop is a static Python loop over M intervals
(M is contract schedule, not data), fully fused by XLA.

The reference platform has constant-parameter Heston only
(src/cpp/models/heston.{hpp,cpp}); this module is a capability beyond it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp

from ..core.precision import result_dtype
from . import heston
from .heston import HestonParams

__all__ = ["TermHestonParams", "make_term_params", "price_term_heston"]


def _riccati_step(u, D0, C0, kappa, th, sig, rho_, tau, i):
    """Advance the Heston log-CF exponents (C, D) by ``tau`` under constant
    parameters, from terminal values (C0, D0) — Mikhailov-Noegel closed form.

    ``tau = 0`` returns (C0, D0) exactly (the g-tilde algebra collapses), so
    intervals clipped away by the maturity cost nothing.
    """
    sigma2 = sig * sig
    xi = kappa - rho_ * sig * i * u
    d = jnp.sqrt(xi * xi + sigma2 * (i * u + u * u))
    # generalized g with non-zero terminal condition D0 (g-tilde)
    gt = (xi - d - sigma2 * D0) / (xi + d - sigma2 * D0)
    e = jnp.exp(-d * tau)
    one_mgte = 1.0 - gt * e
    C = C0 + (kappa * th / sigma2) * (
        (xi - d) * tau - 2.0 * jnp.log(one_mgte / (1.0 - gt))
    )
    D = (xi - d - (xi + d) * gt * e) / (sigma2 * one_mgte)
    return C, D


class TermHestonParams(NamedTuple):
    """Piecewise-constant Heston parameters as a pytree.

    ``edges`` are the M+1 increasing interval boundaries starting at 0.0;
    ``kappas..rhos`` are the per-interval values (shape (M,)).  The scalar
    ``kappa..rho`` base fields (consumed by heston._cf_reduced's base
    exponents, which the hook divides back out) are the first interval's
    values; ``v0`` is the time-0 variance.  Build with
    :func:`make_term_params`.
    """

    kappa: jnp.ndarray
    theta: jnp.ndarray
    sigma: jnp.ndarray
    rho: jnp.ndarray
    v0: jnp.ndarray
    edges: jnp.ndarray
    kappas: jnp.ndarray
    thetas: jnp.ndarray
    sigmas: jnp.ndarray
    rhos: jnp.ndarray

    def cf_reduced_extra(self, u, T, rdt, cdt):
        """exp(C_glued + D_glued v0 - C_base - D_base v0).

        The base (C, D) are recomputed here with the scalar fields — the
        same closed form heston._cf_reduced used — so the product with the
        base reduced CF leaves exactly the glued exponents.  At ``u = -i``
        every interval's Riccati solution is 0, so the factor is 1 and the
        forward is preserved (the hook contract).
        """
        i = jnp.asarray(1j, dtype=cdt)
        v0 = jnp.asarray(self.v0, dtype=rdt)
        zero = jnp.zeros_like(u)

        # glued exponents: backward over the static interval list
        C = zero
        D = zero
        m = self.kappas.shape[0]
        for j in reversed(range(m)):
            lo = jnp.minimum(jnp.asarray(self.edges[j], rdt), T)
            hi = jnp.minimum(jnp.asarray(self.edges[j + 1], rdt), T)
            tau_j = hi - lo
            C, D = _riccati_step(
                u, D, C,
                jnp.asarray(self.kappas[j], rdt),
                jnp.asarray(self.thetas[j], rdt),
                jnp.asarray(self.sigmas[j], rdt),
                jnp.asarray(self.rhos[j], rdt),
                tau_j, i,
            )

        # base exponents over the full [0, T] with the scalar fields
        C_b, D_b = _riccati_step(
            u, zero, zero,
            jnp.asarray(self.kappa, rdt), jnp.asarray(self.theta, rdt),
            jnp.asarray(self.sigma, rdt), jnp.asarray(self.rho, rdt),
            T, i,
        )
        return jnp.exp((C - C_b) + (D - D_b) * v0)

    def interval_params(self, j: int) -> HestonParams:
        return HestonParams(
            self.kappas[j], self.thetas[j], self.sigmas[j], self.rhos[j],
            self.v0,
        )


def make_term_params(
    edges: Sequence[float],
    kappas, thetas, sigmas, rhos,
    v0,
) -> TermHestonParams:
    """Build :class:`TermHestonParams` from interval edges and per-interval
    values.  ``edges`` must start at 0 and be strictly increasing with one
    more entry than the parameter lists."""
    import numpy as np

    e = np.asarray(edges, dtype=float)
    if e[0] != 0.0 or np.any(np.diff(e) <= 0):
        raise ValueError("edges must start at 0 and be strictly increasing")
    m = len(e) - 1
    for name, arr in (("kappas", kappas), ("thetas", thetas),
                      ("sigmas", sigmas), ("rhos", rhos)):
        if len(arr) != m:
            raise ValueError(f"{name} must have {m} entries, got {len(arr)}")
    ka = jnp.asarray(kappas)
    th = jnp.asarray(thetas)
    si = jnp.asarray(sigmas)
    rh = jnp.asarray(rhos)
    return TermHestonParams(
        ka[0], th[0], si[0], rh[0], jnp.asarray(v0),
        jnp.asarray(e), ka, th, si, rh,
    )


def price_term_heston(
    params: TermHestonParams,
    strikes,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
):
    """Price vanillas under the piecewise-constant model through the
    converged composite-GL pricer — one call, any maturity inside or beyond
    the last edge (the last interval's parameters extend to T past it only
    if ``edges[-1] >= T``; pad edges generously)."""
    rdt = result_dtype(maturity, spot)
    T = float(maturity) if not hasattr(maturity, "shape") else maturity
    import numpy as np

    if np.any(np.asarray(params.edges)[-1] < np.asarray(T) - 1e-12):
        raise ValueError(
            "maturity extends past edges[-1]; extend the last interval"
        )
    return heston.price_accurate(
        params, strikes, maturity, spot, rate, dividend, is_call
    )
