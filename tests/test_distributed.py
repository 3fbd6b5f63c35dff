"""Multi-host smoke test: two REAL processes join via jax.distributed.

``initialize_distributed`` is the only multi-host codepath; this exercises
it without
hardware: two local CPU processes, one coordinator, assert the global device
view spans both processes and a cross-process psum works (the cross-host analog of
the reference's K8s replica scale-out, SURVEY.md §2.3).
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = str(Path(__file__).resolve().parents[1])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # conftest's 8-device flag confuses the workers
    return env

_WORKER = textwrap.dedent(
    """
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)  # one device per process

    coordinator, pid = sys.argv[1], int(sys.argv[2])

    from pde_tpu.parallel.mesh import initialize_distributed

    n_global = initialize_distributed(
        coordinator_address=coordinator, num_processes=2, process_id=pid
    )
    assert n_global == 2, f"global view has {n_global} devices"
    assert jax.process_count() == 2
    assert len(jax.local_devices()) == 1

    # cross-process collective: allgather each process's id across hosts
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(jnp.array([pid], dtype=jnp.int32))
    assert sorted(int(v) for v in gathered.ravel()) == [0, 1], gathered

    # and a global psum through a mesh built by make_mesh
    from pde_tpu.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(2, axis_names=("dp",), shape=(2,))
    ones = jax.make_array_from_callback(
        (2,), NamedSharding(mesh, P("dp")), lambda idx: jnp.ones((1,), jnp.float32)
    )
    total = jax.jit(lambda x: jnp.sum(x), out_shardings=NamedSharding(mesh, P()))(ones)
    assert float(total) == 2.0, float(total)

    print(f"WORKER_{pid}_OK")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_initialize_and_psum(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env=_env(),
        )
        for pid in (0, 1)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"worker {pid} timed out joining the cluster")
        outs.append((p.returncode, out, err))

    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{err[-2000:]}"
        assert f"WORKER_{pid}_OK" in out


_STEP_WORKER = textwrap.dedent(
    """
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)  # two devices per process

    coordinator, pid = sys.argv[1], int(sys.argv[2])

    from pde_tpu.parallel.mesh import initialize_distributed

    n_global = initialize_distributed(
        coordinator_address=coordinator, num_processes=2, process_id=pid
    )
    assert n_global == 4, f"global view has {n_global} devices"

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pde_tpu.parallel.mesh import make_mesh, sharded_calibration_step
    from pde_tpu.parallel.mesh import _price_population

    # 2x2 mesh: dp spans the two PROCESSES (cross-host analog), quotes the
    # two devices within each process (within-host analog)
    mesh = make_mesh(4, shape=(2, 2))
    U, Q = 2, 8

    # identical deterministic data in every process; each process's devices
    # materialize their own global-array shards from it
    true_x = np.tile([2.0, 0.04, 0.3, -0.7, 0.04], (U, 1)).astype(np.float32)
    strikes = np.tile(np.linspace(90.0, 110.0, Q), (U, 1)).astype(np.float32)
    mats = np.full((U, Q), 0.5, dtype=np.float32)
    x0 = np.tile([1.0, 0.09, 0.5, -0.2, 0.09], (U, 1)).astype(np.float32)
    lam = np.full((U,), 1e-3, dtype=np.float32)

    target = np.asarray(
        jax.vmap(lambda x, k, t: _price_population(x, k, t, 100.0, 0.05, 0.0))(
            jnp.asarray(true_x), jnp.asarray(strikes), jnp.asarray(mats)
        )
    )
    target = np.maximum(target, 1e-3)

    def garr(np_val, spec):
        return jax.make_array_from_callback(
            np_val.shape, NamedSharding(mesh, spec),
            lambda idx: jnp.asarray(np_val[idx]),
        )

    lower = jnp.asarray([0.1, 0.01, 0.01, -0.99, 0.01], jnp.float32)
    upper = jnp.asarray([10.0, 1.0, 2.0, 0.99, 1.0], jnp.float32)
    step = sharded_calibration_step(mesh, lower, upper)

    x_g = garr(x0, P("dp", None))
    k_g = garr(strikes, P("dp", "quotes"))
    t_g = garr(mats, P("dp", "quotes"))
    y_g = garr(target, P("dp", "quotes"))
    l_g = garr(lam, P("dp"))

    cost_prev = None
    for _ in range(6):
        x_g, cost, l_g = step(x_g, k_g, t_g, y_g, l_g, 100.0, 0.05, 0.0)
    from jax.experimental import multihost_utils

    cost_h = multihost_utils.process_allgather(cost, tiled=True)
    x_h = multihost_utils.process_allgather(x_g, tiled=True)
    assert np.all(np.isfinite(cost_h)), cost_h
    # every process sees the same global result
    assert x_h.shape == (U, 5), x_h.shape

    print(f"STEP_WORKER_{pid}_OK cost={float(np.ravel(cost_h)[0]):.3e}")
    """
)


@pytest.mark.slow
def test_two_process_sharded_calibration_step(tmp_path):
    """The FULL sharded LM calibration step SPMD across two processes: dp
    axis across the process boundary, quotes axis over each process's local
    devices — the multi-host analog of the single-process mesh tests."""
    worker = tmp_path / "step_worker.py"
    worker.write_text(_STEP_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
            env=_env(),
        )
        for pid in (0, 1)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"step worker {pid} timed out")
        outs.append((p.returncode, out, err))

    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"step worker {pid} failed:\n{err[-2000:]}"
        assert f"STEP_WORKER_{pid}_OK" in out


_IMPORT_HYGIENE_WORKER = textwrap.dedent(
    """
    # Import the ENTIRE package first; jax.distributed.initialize must
    # still be callable afterwards.  Any module-level jnp.array (or other
    # backend-touching call) in any pde_tpu module breaks every multi-host
    # worker with 'initialize() must be called before any JAX calls' —
    # regression: calibrate/rates.py once held module-level jnp bounds.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)

    import pde_tpu  # noqa: F401  (pulls in models/calibrate/solvers/...)
    import pde_tpu.calibrate  # noqa: F401
    import pde_tpu.solvers  # noqa: F401
    import pde_tpu.parallel.mesh  # noqa: F401

    import sys
    jax.distributed.initialize(
        coordinator_address=sys.argv[1], num_processes=1, process_id=0
    )
    assert jax.process_count() == 1
    print("IMPORT_HYGIENE_OK")
    """
)


def test_package_import_keeps_distributed_init_possible(tmp_path):
    """Importing pde_tpu must NOT initialise the XLA backend (multi-host
    workers call jax.distributed.initialize after importing the package)."""
    worker = tmp_path / "hygiene_worker.py"
    worker.write_text(_IMPORT_HYGIENE_WORKER)
    coordinator = f"127.0.0.1:{_free_port()}"
    p = subprocess.run(
        [sys.executable, str(worker), coordinator],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=240,
    )
    assert p.returncode == 0, f"hygiene worker failed:\n{p.stderr[-2000:]}"
    assert "IMPORT_HYGIENE_OK" in p.stdout
