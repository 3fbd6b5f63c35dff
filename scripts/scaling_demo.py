#!/usr/bin/env python
"""Multi-chip scaling demonstration on a virtual CPU mesh.

Sweeps device counts (1/2/4/8 virtual CPU devices) and, for each, runs the
sharded calibration step over a growing number of underlyings, printing a
weak-scaling table: underlyings are sharded over the ``dp`` axis and the
quote axis over ``quotes``; the LM normal equations all-reduce over quotes
(`jax.lax.psum` between devices on real hardware).

This mirrors how the driver's ``dryrun_multichip`` validates the sharding,
but measures throughput so the scaling SHAPE is visible without real chips.
Absolute numbers on a forced-host mesh are meaningless; the point is that
per-device work stays constant as devices grow (weak scaling), which is the
property that transfers to real multi-device hardware.

Run: python scripts/scaling_demo.py
"""

import subprocess
import sys

CHILD = r"""
import time
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", {n})
import jax.numpy as jnp

from pde_tpu.parallel.mesh import make_mesh, sharded_calibration_step, _price_population

n = {n}
mesh = make_mesh(n)
dp, qs = mesh.shape["dp"], mesh.shape["quotes"]
U = dp * 8            # 8 surfaces per dp shard: weak scaling
Q = qs * 16

dtype = jnp.float32
strikes = jnp.asarray(np.tile(np.linspace(85.0, 115.0, Q), (U, 1)), dtype=dtype)
mats = jnp.asarray(np.full((U, Q), 0.75), dtype=dtype)
true_x = jnp.asarray(np.tile([2.0, 0.04, 0.3, -0.7, 0.04], (U, 1)), dtype=dtype)
lower = jnp.asarray([0.1, 0.01, 0.01, -0.99, 0.01], dtype=dtype)
upper = jnp.asarray([10.0, 1.0, 2.0, 0.99, 1.0], dtype=dtype)
target = jax.vmap(lambda x, k, t: _price_population(x, k, t, 100.0, 0.05, 0.0))(
    true_x, strikes, mats)
target = jnp.maximum(target, 1e-3)
x0 = jnp.asarray(np.tile([1.0, 0.09, 0.5, -0.2, 0.09], (U, 1)), dtype=dtype)
lam = jnp.full((U,), 1e-3, dtype=dtype)

step = sharded_calibration_step(mesh, lower, upper)
out = step(x0, strikes, mats, target, lam, 100.0, 0.05, 0.0)
jax.block_until_ready(out)          # compile
reps = 20
t0 = time.perf_counter()
for _ in range(reps):
    out = step(x0, strikes, mats, target, lam, 100.0, 0.05, 0.0)
jax.block_until_ready(out)
per = (time.perf_counter() - t0) / reps
import json
# all virtual devices share one host's cores, so wall time grows with TOTAL
# work; the sharding-overhead signal is the per-work-unit cost staying flat
work_units = U * (Q / 16.0)
print(json.dumps({{"devices": n, "mesh": [dp, qs], "underlyings": U,
                   "quotes": Q, "step_ms": round(per * 1e3, 2),
                   "ms_per_surface_block": round(per * 1e3 / work_units, 3)}}))
"""


def main() -> int:
    print("# sharding-overhead sweep: 8 surfaces per dp shard, 16 quotes per quote shard")
    print("# virtual CPU devices share one host, so step_ms tracks TOTAL work;")
    print("# flat ms_per_surface_block across mesh sizes = sharding adds no overhead")
    for n in (1, 2, 4, 8):
        proc = subprocess.run(
            [sys.executable, "-c", CHILD.format(n=n)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            print(f"devices={n} FAILED:\n{proc.stderr[-800:]}", file=sys.stderr)
            return 1
        out = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        print(out[-1] if out else proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
