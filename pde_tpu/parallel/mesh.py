"""Device mesh and sharding policies — the distributed-communication layer.

The reference scales out with microservice replicas behind REST +
TimescaleDB/Redis (SURVEY.md section 2.3); the JAX equivalent is a
single-controller program over a ``jax.sharding.Mesh`` whose collectives
XLA hands to NCCL.  Two named axes:

* ``dp`` — data parallel over underlyings/surfaces (the reference's
  "replica" axis: each calibration is independent);
* ``quotes`` — parallel over the quote axis within one surface (strike x
  maturity); residual reductions (J^T J, J^T r, objective sums) become XLA
  all-reduces over this axis.

:func:`make_mesh` builds the mesh; :func:`sharded_calibration_step` returns a
jitted batched Levenberg-Marquardt calibration step with explicit
``NamedSharding`` on every operand — the "training step" of this framework.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.heston import HestonParams
from ..models import heston as heston_model

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "sharded_calibration_step",
    "best_factorization",
]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-host entry point: join this process to a multi-host cluster.

    The reference scales across hosts with K8s replicas + a message broker
    (SURVEY.md §2.3); the JAX equivalent is ``jax.distributed`` — one
    controller process per host, after which ``jax.devices()`` spans every
    host and :func:`make_mesh` lays its axes over them.

    A bare call is a no-op that returns the local device count — explicit
    arguments opt in to multi-host.  Pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id``: nothing is
    sniffed from the environment.
    """
    if not (coordinator_address is None and num_processes is None and process_id is None):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return len(jax.devices())


def best_factorization(n: int, n_underlyings: Optional[int] = None) -> tuple[int, int]:
    """Factor n devices into (dp, quotes) mesh axes.

    With ``n_underlyings`` given, the choice follows communication counting
    rather than squareness: the dp axis carries NO collective traffic
    (surfaces are independent) while the quotes axis all-reduces every
    J^T J / J^T r / objective contraction — so dp should be as large as the
    workload can fill.  ``dp = `` the largest divisor of n that also
    divides U (perfect balance: every dp shard gets U/dp whole surfaces —
    a dp that is merely <= U cannot lay the U axis out over the mesh at
    all, e.g. U=6 on 8 devices must pick dp=2, not dp=4); when n divides U
    that is pure dp with zero collectives.  Without a workload hint, fall
    back to the most even split (dp >= quotes) — a neutral default for
    unknown U.  ``calibrate_batch`` additionally pads U up to a dp multiple
    when handed a mesh whose dp does not divide U.
    """
    if n_underlyings is not None and n_underlyings > 0:
        dp = max(
            d for d in range(1, n + 1)
            if n % d == 0 and n_underlyings % d == 0
        )
        return (dp, n // dp)
    best = (n, 1)
    for q in range(1, int(np.sqrt(n)) + 1):
        if n % q == 0:
            best = (n // q, q)
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "quotes"),
    shape: Optional[Sequence[int]] = None,
    n_underlyings: Optional[int] = None,
) -> Mesh:
    """Build a 2D mesh over the available devices.

    The cards of one host are joined all to all by NVLink, so the device
    order carries no topology and the mesh follows the algorithm alone:
    the default factorization puts the larger axis on ``dp`` (independent
    surfaces, no communication) and the smaller on ``quotes`` (all-reduce
    traffic stays on the short axis).  Pass ``n_underlyings`` to size dp to the workload
    (see :func:`best_factorization`) — with U >= devices this yields a pure
    dp mesh with zero collective traffic.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        shape = best_factorization(n_devices, n_underlyings)
    mesh_devices = np.asarray(devices).reshape(tuple(shape))
    return Mesh(mesh_devices, tuple(axis_names))


def _price_population(x, strikes, maturities, S0, r, q, is_call=True,
                      n_points=64):
    """Vectorized pricing for mesh-sharded calibration.

    Prices on the Euler-Maclaurin-corrected Gauss-Legendre rule
    (models/heston.py:_gl_ref_rule): numerically the reference 1024 x 0.01
    objective (~1e-9 price agreement) at 15x fewer quadrature points, so
    the sharded LM refinement optimizes the same objective as the
    single-device stage, which prices through the same rule.
    """
    p = HestonParams(x[..., 0], x[..., 1], x[..., 2], x[..., 3], x[..., 4])
    return heston_model.price_carr_madan_gl(
        p, strikes, maturities, S0, r, q, is_call=is_call,
        n_points=n_points,
    )


def sharded_calibration_step(mesh: Mesh, lower, upper):
    """Jitted one-iteration batched LM calibration step over a mesh.

    Inputs (U = underlyings, Q = quotes per surface):
      x          (U, 5)  current parameter iterates    -> sharded (dp, -)
      strikes    (U, Q)  quote strikes                 -> sharded (dp, quotes)
      maturities (U, Q)                                -> sharded (dp, quotes)
      target     (U, Q)  market prices                 -> sharded (dp, quotes)
      lam        (U,)    LM damping                    -> sharded (dp,)

    Returns (x_new, cost).  The J^T J / J^T r contractions over Q are
    executed as XLA reduce/all-reduce over the ``quotes`` axis; the U axis is
    embarrassingly parallel over ``dp``.  This function is the
    ``dryrun_multichip`` "full training step" and the building block of the
    production multi-chip calibration service.
    """
    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)

    dp = P("dp", None)
    dq = P("dp", "quotes")
    d1 = P("dp")

    def step(x, strikes, maturities, target, lam, S0, r, q, is_call=True):
        def residuals_one(xi, ki, ti, yi):
            prices = jnp.maximum(
                _price_population(xi, ki, ti, S0, r, q, is_call), 1e-10
            )
            return (prices - yi) / yi

        def one_underlying(xi, ki, ti, yi, lam_i):
            res = residuals_one(xi, ki, ti, yi)
            J = jax.jacfwd(residuals_one)(xi, ki, ti, yi)  # (Q, 5)
            hi = jax.lax.Precision.HIGHEST  # TF32 is too coarse for
            # normal equations (see calibrate/lm.py)
            JTJ = jnp.matmul(J.T, J, precision=hi)  # sharded Q -> all-reduce
            JTr = jnp.matmul(J.T, res, precision=hi)
            A = JTJ + lam_i * jnp.diag(jnp.maximum(jnp.diag(JTJ), 1e-12))
            delta = -jnp.linalg.solve(A + 1e-14 * jnp.eye(5, dtype=xi.dtype), JTr)
            x_new = jnp.clip(xi + delta, lower, upper)
            cost_new = 0.5 * jnp.sum(residuals_one(x_new, ki, ti, yi) ** 2)
            cost_old = 0.5 * jnp.sum(res**2)
            accept = cost_new < cost_old
            return (
                jnp.where(accept, x_new, xi),
                jnp.where(accept, cost_new, cost_old),
                jnp.where(accept, lam_i / 3.0, lam_i * 2.0),
            )

        return jax.vmap(one_underlying)(x, strikes, maturities, target, lam)

    return jax.jit(
        step,
        in_shardings=(
            NamedSharding(mesh, dp),  # x
            NamedSharding(mesh, dq),  # strikes
            NamedSharding(mesh, dq),  # maturities
            NamedSharding(mesh, dq),  # target
            NamedSharding(mesh, d1),  # lam
            None,
            None,
            None,
        ),
        out_shardings=(
            NamedSharding(mesh, dp),
            NamedSharding(mesh, d1),
            NamedSharding(mesh, d1),
        ),
    )
