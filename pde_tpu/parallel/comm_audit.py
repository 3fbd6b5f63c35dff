"""Communication accounting for the sharded device programs.

Multi-chip scaling on real hardware is set by how many collectives each
step issues and how many bytes they move between devices — numbers that are fully
determined at COMPILE time.  This module extracts them from the optimized
HLO of the sharded programs, so the scaling story can be stated (and
regression-tested) without multi-chip hardware: the per-step collective
count must be INDEPENDENT of the mesh size, and the payload per device must
SHRINK with it.  (The reference's scaling unit is a K8s service replica
with REST/DB as the data plane, SURVEY.md §2.3; here the data plane is XLA
collectives between devices, and this is its audit.)

Measured shape of each program (asserted in tests/test_comm_audit.py):

* ``sharded_bs_solve`` — per CN step: 2 ``collective-permute`` (one-row
  halos for the explicit half-step) + the partitioned-Thomas interface
  ``all-gather`` (8 scalars/system/device).
* ``sharded_heston_solve`` — per Douglas ADI step: 2 ``collective-permute``
  (halo rows of the (m, nv) local block) + 1 ``all-gather`` (8 scalars per
  v-level per device, the reduced interface system of the S-sweep); the
  v-sweep is axis-local and communication-free.
* ``dist_tridiagonal_solve`` — 1 ``all-gather`` total (Wang's partitioned
  Thomas: local elimination and back-substitution are compute-only).
* ``sharded_calibration_step`` — ``all-reduce``s of the J^T J / J^T r /
  cost contractions over the quotes axis (5x5 + 5 + scalars per surface,
  mesh-size-independent payload).
* ``price_american_lsm_sharded`` — 4 ``all-reduce`` instructions total:
  XLA fuses the backward step's ~6 logical psums (ITM count, feature
  means/variances, Gram, rhs) into a couple of all-reduces inside the scan
  body, plus one for the final price/stderr moments — ~50 scalars per
  exercise date regardless of path count or mesh size.
* ``calibrate_leverage_sharded`` — 3 ``all-reduce`` instructions total:
  the distributed particle method's per-step bin statistics (counts +
  v-sums + global-mean fallback, ~2*n_bins + 2 scalars) fuse into one
  all-reduce inside the scan body, plus two for the validation price
  moments — the conditional expectation E[v|S] is global at every step
  for the cost of one fused psum.

All counts are static instruction counts in the compiled program — a
``lax.scan`` emits its body ONCE inside a while loop, so a count of 2
collective-permutes means 2 per TIME STEP at runtime.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np

import jax

__all__ = ["COLLECTIVE_OPS", "collective_counts", "audit_table"]

COLLECTIVE_OPS = (
    "collective-permute",
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
)


def collective_counts(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """Compile ``fn(*args, **kwargs)`` and count collective INSTRUCTIONS.

    Counts instruction call sites (``op(...)``) in the optimized HLO — an
    op inside a while-loop body counts once even though it runs every
    iteration, which is exactly the per-step figure the scaling analysis
    needs.  ``fn`` is wrapped in ``jax.jit`` (idempotent if already jitted).
    """
    txt = jax.jit(fn).lower(*args, **kwargs).compile().as_text()
    counts = {}
    for op in COLLECTIVE_OPS:
        # instruction form: "%all-gather.3 = ... all-gather(%operand, ...)"
        counts[op] = len(re.findall(re.escape(op) + r"[\w.\-]*\(", txt))
    return counts


def _mesh(k: int, name: str):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:k]), (name,))


def audit_table(mesh_sizes=(2, 4, 8)) -> dict[str, dict[int, dict[str, int]]]:
    """Collective counts of every sharded program at each mesh size.

    Returns ``{program: {mesh_size: {op: count}}}``.  Needs
    ``len(jax.devices()) >= max(mesh_sizes)`` (use the virtual CPU mesh:
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8``).
    """
    import jax.numpy as jnp

    from ..solvers.bs_pde import BSPDEParams
    from ..solvers.heston_adi import HestonPDEParams
    from .adi_sharded import sharded_bs_solve, sharded_heston_solve
    from .dist_tridiag import dist_tridiagonal_solve
    from .mesh import make_mesh, sharded_calibration_step

    out: dict[str, dict[int, dict[str, int]]] = {}

    for k in mesh_sizes:
        gm = _mesh(k, "grid")

        bsp = BSPDEParams(K=100.0, T=0.5, sigma=0.2, r=0.05,
                          n_space=16 * k, n_time=4)
        out.setdefault("sharded_bs_solve", {})[k] = collective_counts(
            lambda: sharded_bs_solve(gm, bsp, 100.0).prices
        )

        hp = HestonPDEParams(n_spot=8 * k, n_vol=8, n_time=4)
        out.setdefault("sharded_heston_solve", {})[k] = collective_counts(
            lambda: sharded_heston_solve(gm, hp, 100.0).prices
        )

        n = 16 * k
        lower = jnp.full((n - 1,), -1.0)
        diag = jnp.full((n,), 4.0)
        upper = jnp.full((n - 1,), -1.0)
        rhs = jnp.arange(n, dtype=jnp.float32)
        out.setdefault("dist_tridiagonal_solve", {})[k] = collective_counts(
            lambda: dist_tridiagonal_solve(lower, diag, upper, rhs, gm)
        )

        from ..models.heston import HestonParams
        from .mc import price_american_lsm_sharded

        dm = make_mesh(k, axis_names=("dp",), shape=(k,))
        out.setdefault("price_american_lsm_sharded", {})[k] = collective_counts(
            lambda: price_american_lsm_sharded(
                HestonParams(2.0, 0.04, 0.3, -0.7, 0.04), 100.0, 0.5, 100.0,
                jax.random.PRNGKey(0), dm,
                rate=0.05, n_steps=4, n_paths=128 * k,
            )[0]
        )

        from .mc import calibrate_leverage_sharded

        out.setdefault("calibrate_leverage_sharded", {})[k] = (
            collective_counts(
                lambda: calibrate_leverage_sharded(
                    HestonParams(2.0, 0.04, 0.3, -0.7, 0.04),
                    lambda s, t: jnp.full_like(s, 0.2), 100.0, 0.5,
                    jax.random.PRNGKey(1), dm,
                    rate=0.05, n_steps=4, n_paths=128 * k, n_bins=9,
                )[1]
            )
        )

        if k >= 2:
            cm = make_mesh(k, shape=(1, k))
            lo = jnp.array([0.1, 0.01, 0.01, -0.99, 0.01])
            hi = jnp.array([10.0, 1.0, 2.0, 0.99, 1.0])
            step = sharded_calibration_step(cm, lo, hi)
            U, Q = 1, 8 * k
            x0 = jnp.tile(jnp.array([1.0, 0.09, 0.5, -0.2, 0.09]), (U, 1))
            strikes = jnp.tile(jnp.linspace(90.0, 110.0, Q), (U, 1))
            mats = jnp.full((U, Q), 0.5)
            target = jnp.full((U, Q), 5.0)
            lam = jnp.full((U,), 1e-3)
            out.setdefault("sharded_calibration_step", {})[k] = (
                collective_counts(
                    step, x0, strikes, mats, target, lam, 100.0, 0.05, 0.0
                )
            )
    return out


def main():  # pragma: no cover — CLI entry (benchmarks/comm_audit)
    table = audit_table()
    for prog, by_k in table.items():
        print(f"\n{prog}")
        for k, counts in sorted(by_k.items()):
            nz = {op: c for op, c in counts.items() if c}
            print(f"  mesh={k}: {nz or '(no collectives)'}")


if __name__ == "__main__":  # pragma: no cover
    main()
