#!/usr/bin/env python
"""Time each fused PDE march kernel against the plain XLA routes on a GPU.

For the Heston ADI book (B=512, 100x50x100) and the local-vol book
(B=256, 200x100) it times, end to end through the public entry points:

* ``kernel`` — the fused Pallas (Triton) march;
* ``scan``   — the ``lax.scan`` Thomas twin (``heston_adi.solve_batch``,
  ``local_vol_pde.solve_batch``);
* ``gtsv``   — the same scan march with every tridiagonal solve done by
  ``ops.tridiag.gtsv`` (one cuSPARSE ``gtsv2`` call per sweep).

Each time is the median of ``--reps`` calls that end in
``block_until_ready``, after a warm-up call; routes run in the order
kernel, scan, gtsv, gtsv, scan, kernel.  Run with ``python
benchmarks/pde_march_routes.py`` on the machine with the card; the last
line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


@contextlib.contextmanager
def _patched(module, **names):
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _fresh(jitted):
    """A new function object with the body of a jitted function: its own
    trace cache, so it traces again under :func:`_patched`."""
    f = jitted.__wrapped__
    g = types.FunctionType(f.__code__, f.__globals__, f.__name__,
                           f.__defaults__, f.__closure__)
    g.__kwdefaults__ = f.__kwdefaults__
    return g


def _time(fn, reps):
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _warm(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def adi_routes(B=512, nS=100, nv=50, nT=100, interpret=False):
    import jax
    import jax.numpy as jnp

    from pde_tpu.ops import tridiag
    from pde_tpu.solvers import heston_adi

    f32 = jnp.float32
    K = jnp.asarray(np.linspace(85.0, 115.0, B), f32)
    T = jnp.asarray(np.linspace(0.25, 1.5, B), f32)
    c = jnp.asarray((np.arange(B) % 2).astype(np.float32))
    args = (2.0, 0.04, 0.3, -0.7, 0.04, 0.05, 0.02, T, K)
    grid = dict(n_spot=nS, n_vol=nv, n_time=nT)
    static = ("american", "american_method", "n_spot", "n_vol", "n_time",
              "s_min_mult", "s_max_mult", "v_max")
    gtsv_batch = jax.jit(_fresh(heston_adi.solve_batch),
                         static_argnames=static)
    routes = {
        "kernel": lambda: heston_adi.solve_fused_batch(
            *args, c, 100.0, interpret=interpret, **grid).price,
        "scan": lambda: heston_adi.solve_batch(
            *args, c > 0.5, 100.0, **grid).price,
        "gtsv": lambda: gtsv_batch(*args, c > 0.5, 100.0, **grid).price,
    }
    outs = {k: _warm(routes[k]) for k in ("kernel", "scan")}
    with _patched(heston_adi,
                  thomas_factor=lambda lo, d, up: (lo, d, up),
                  thomas_solve_factored=lambda f, rhs: tridiag.gtsv(*f, rhs)):
        outs["gtsv"] = _warm(routes["gtsv"])
    return B, routes, outs


def lv_routes(B=256, n=200, nT=100, interpret=False):
    import jax
    import jax.numpy as jnp

    from pde_tpu.models import heston, local_vol
    from pde_tpu.ops import tridiag
    from pde_tpu.solvers import local_vol_pde

    f32 = jnp.float32
    params = heston.HestonParams(2.0, 0.04, 0.3, -0.7, 0.04)
    ks = jnp.asarray(np.exp(np.linspace(np.log(60.0), np.log(170.0), 24)))
    ts = jnp.asarray(np.linspace(0.05, 1.0, 6))
    surf = jax.jit(lambda: local_vol.dupire_surface(
        params, ks, ts, 100.0, 0.04, 0.01))()
    interp = local_vol.SurfaceInterpolator(ks, ts, surf)
    K = jnp.asarray(np.linspace(70.0, 140.0, B), f32)
    T = jnp.asarray(np.linspace(0.25, 1.5, B), f32)
    c = jnp.asarray((np.arange(B) % 2).astype(np.float32))
    kw = dict(K=K, T=T, is_call=c, r=0.04, q=0.01, n_space=n, n_time=nT)
    static = ("vol_fn", "n_space", "n_time", "s_min_mult", "s_max_mult",
              "scheme")
    gtsv_impl = jax.jit(_fresh(local_vol_pde._solve_batch_scan_impl),
                        static_argnames=static)

    def gtsv_route():
        with _patched(local_vol_pde, _solve_batch_scan_impl=gtsv_impl):
            return local_vol_pde.solve_batch(interp, 100.0, **kw).price

    routes = {
        "kernel": lambda: local_vol_pde.solve_fused_batch(
            interp, 100.0, interpret=interpret, **kw).price,
        "scan": lambda: local_vol_pde.solve_batch(interp, 100.0, **kw).price,
        "gtsv": gtsv_route,
    }
    outs = {k: _warm(routes[k]) for k in ("kernel", "scan")}
    with _patched(local_vol_pde, thomas=tridiag.gtsv):
        outs["gtsv"] = _warm(routes["gtsv"])
    return B, routes, outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes, kernels in interpret mode, any device")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        sys.exit(f"no GPU: JAX found {dev.platform!r}")
    smi = "" if args.rehearse else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"# {dev.device_kind} x{len(jax.devices())}; {smi.strip()}")

    result = {"device": dev.device_kind, "nvidia_smi": smi.strip()}
    small = dict(interpret=True) if args.rehearse else {}
    adi_kw = dict(B=8, nS=16, nv=8, nT=4, **small) if small else {}
    lv_kw = dict(B=8, n=16, nT=4, **small) if small else {}
    for name, build, kw in (("heston_adi_b512", adi_routes, adi_kw),
                            ("local_vol_b256", lv_routes, lv_kw)):
        B, routes, outs = build(**kw)
        ref = np.asarray(outs["scan"][0], np.float64)
        row = {"compile_s": {k: round(v[1], 3) for k, v in outs.items()},
               "max_abs_vs_scan": {
                   k: float(np.max(np.abs(np.asarray(v[0], np.float64) - ref)))
                   for k, v in outs.items()}}
        order = ["kernel", "scan", "gtsv", "gtsv", "scan", "kernel"]
        times = {k: [] for k in routes}
        for k in order:
            times[k].append(_time(routes[k], args.reps))
        row["seconds"] = {k: v for k, v in times.items()}
        row["options_per_s"] = {k: B / min(v) for k, v in times.items()}
        print(f"# {name}: {json.dumps(row)}", flush=True)
        result[name] = row
    print(json.dumps(result))


if __name__ == "__main__":
    main()
