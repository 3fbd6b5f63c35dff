"""Bounded Levenberg-Marquardt in pure JAX.

Replaces the reference's scipy ``least_squares(method='trf')`` local stage
(calibration/heston_calibrator.py:469-477) with a jit-compiled, vmap-able LM:

* Jacobians via ``jax.jacfwd`` (5 forward tangents for Heston — exact, no FD);
* damped normal equations solved per iteration, lambda adapted by
  accept/reject with masked (fixed-trip-count) control flow;
* box bounds by projection, so the iterate stays feasible like TRF;
* an optional ``axis_name`` lets residuals live sharded across devices: JTJ
  and JTr are then reduced with ``lax.psum`` over the mesh axis — calibration
  scales over the quote axis with XLA collectives (SURVEY.md section 2.3).

``vmap`` over x0 calibrates many surfaces (or multistarts) concurrently.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["LMResult", "levenberg_marquardt"]


class LMResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray  # 0.5 * sum(residuals^2), scipy convention
    n_iter: jnp.ndarray
    converged: jnp.ndarray
    grad_norm: jnp.ndarray


def levenberg_marquardt(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    max_iter: int = 50,
    lam0: float = 1e-3,
    ftol: float = 1e-10,
    gtol: float = 1e-10,
    xtol: float = 1e-10,
    axis_name: Optional[str] = None,
) -> LMResult:
    """Minimize 0.5 ||residual_fn(x)||^2 subject to lower <= x <= upper.

    ``residual_fn`` maps (n_params,) -> (n_residuals,).  With ``axis_name``
    set, each device holds a shard of the residuals and the normal equations
    are psum-reduced across the named mesh axis.
    """
    x0 = jnp.clip(jnp.asarray(x0), lower, upper)
    n = x0.shape[0]
    eye = jnp.eye(n, dtype=x0.dtype)
    # The scipy-convention defaults (1e-10) are unreachable in float32, where
    # relative cost improvements bottom out near machine epsilon (~1.2e-7) —
    # on the float32 device path the march would always report
    # converged=False.
    # Floor the tolerances at a small multiple of the working precision.
    eps = float(jnp.finfo(x0.dtype).eps)
    ftol = max(ftol, 4.0 * eps)
    gtol = max(gtol, 4.0 * eps)
    xtol = max(xtol, 4.0 * eps)

    def half_sq(r):
        c = 0.5 * jnp.sum(r * r)
        if axis_name is not None:
            c = jax.lax.psum(c, axis_name)
        return c

    def normal_eqs(x):
        r = residual_fn(x)
        J = jax.jacfwd(residual_fn)(x)
        # HIGHEST precision: a GPU may run a default-precision f32 matmul
        # in TF32 (10 mantissa bits) — at the Jacobians' 1e8-ish condition
        # numbers that turns J^T J into noise and the march stalls far from
        # the optimum.  The matrices are tiny, so full-precision
        # accumulation costs nothing.
        hi = jax.lax.Precision.HIGHEST
        JTJ = jnp.matmul(J.T, J, precision=hi)
        JTr = jnp.matmul(J.T, r, precision=hi)
        if axis_name is not None:
            JTJ = jax.lax.psum(JTJ, axis_name)
            JTr = jax.lax.psum(JTr, axis_name)
        return half_sq(r), JTJ, JTr

    cost0, JTJ0, JTr0 = normal_eqs(x0)

    class Carry(NamedTuple):
        x: jnp.ndarray
        cost: jnp.ndarray
        JTJ: jnp.ndarray
        JTr: jnp.ndarray
        lam: jnp.ndarray
        done: jnp.ndarray
        n_iter: jnp.ndarray

    init = Carry(
        x=x0,
        cost=cost0,
        JTJ=JTJ0,
        JTr=JTr0,
        lam=jnp.asarray(lam0, dtype=x0.dtype),
        done=jnp.asarray(False),
        n_iter=jnp.asarray(0),
    )

    def body(carry: Carry, _):
        # Marquardt scaling: lam * diag(JTJ) keeps steps well-conditioned
        damp = carry.lam * jnp.maximum(jnp.diag(carry.JTJ), 1e-12)
        A = carry.JTJ + jnp.diag(damp) + 1e-14 * eye
        delta = -jnp.linalg.solve(A, carry.JTr)
        x_new = jnp.clip(carry.x + delta, lower, upper)

        cost_new, JTJ_new, JTr_new = normal_eqs(x_new)
        accept = cost_new < carry.cost

        rel_impr = (carry.cost - cost_new) / jnp.maximum(carry.cost, 1e-300)
        # ftol fires only when the damping is back at (or below) trust level:
        # with lam inflated by earlier rejected steps, an accepted step is
        # lam-strangled — its improvement is small because the STEP is small,
        # not because the optimum is near, and stopping there strands the
        # solve on curved ridges (seen on the Heston kappa-sigma ridge: cost
        # 2.6e-4 "converged" vs 1e-26 after a fresh-lambda restart).
        trusted = carry.lam <= lam0
        conv = accept & (rel_impr < ftol) & trusted
        conv = conv | (jnp.max(jnp.abs(carry.JTr)) < gtol)
        # xtol (scipy TRF semantics): the actual step has shrunk to working
        # precision relative to x — fires also on REJECTED steps, which is
        # how an f32 march at the optimum terminates (no step can lower the
        # cost by more than round-off, so `accept` alone never converges).
        # Guard: a rejected step only counts when the cost barely moved
        # (|rel_impr| < ftol) — the at-the-optimum signature.  Without it,
        # repeated rejections of genuinely bad steps (lam doubling shrinks
        # delta geometrically) could fake convergence with a large gradient.
        step_norm = jnp.linalg.norm(x_new - carry.x)
        step_small = step_norm <= xtol * (xtol + jnp.linalg.norm(carry.x))
        conv = conv | (step_small & (accept | (jnp.abs(rel_impr) < ftol)))
        done = carry.done | conv

        step = lambda new, old: jnp.where(accept & ~carry.done, new, old)
        out = Carry(
            x=step(x_new, carry.x),
            cost=step(cost_new, carry.cost),
            JTJ=step(JTJ_new, carry.JTJ),
            JTr=step(JTr_new, carry.JTr),
            lam=jnp.where(
                carry.done,
                carry.lam,
                jnp.where(accept, carry.lam / 3.0, carry.lam * 2.0),
            ),
            done=done,
            n_iter=carry.n_iter + jnp.where(carry.done, 0, 1),
        )
        return out, None

    final, _ = jax.lax.scan(body, init, None, length=max_iter)
    return LMResult(
        x=final.x,
        cost=final.cost,
        n_iter=final.n_iter,
        converged=final.done,
        grad_norm=jnp.max(jnp.abs(final.JTr)),
    )
