"""Fused 1D Crank-Nicolson march with TIME-DEPENDENT coefficients.

The local-volatility PDE makes all three diagonals functions of the time
level (reference counterpart: the generalized per-step march of
black_scholes_pde.hpp:234-274, one C++ solve per option).  The per-step
operator rows are precomputed for all time levels before the kernel
(:func:`pde_tpu.solvers.local_vol_pde._book_bands`), and the whole
backward march runs inside ONE Pallas (Triton) kernel.

Each program marches a block of 16 options; every vector op
carries the whole block (options are the contiguous axis of every array),
and the time loop and both Thomas passes are loops inside the program.
Each step makes one pass up the grid (explicit half-step, elimination of
the new implicit operator, fused) and one pass down (back substitution,
Dirichlet boundaries, American floor).  Every thread reads only the
option lanes it wrote itself, so no barrier is needed.  Pivots are true
divides, so the march has no sign condition on the operator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["fused_cn_march_1d_tv"]

# options per program (one warp): a row op carries the whole block
_BLOCK_B = 16
_NUM_WARPS = 1


@functools.partial(
    jax.jit,
    static_argnames=("n_space", "n_time", "w", "interpret"),
)
def fused_cn_march_1d_tv(
    pay,          # (n, B) per-option payoff profile on its K-scaled grid
    bands,        # (n_time+1, 3n, B): [L_m; L_c; L_p] rows at time level k,
                  # where level k means calendar time T - k*dt (k=0 is
                  # expiry).  Step k uses level k (explicit side) and level
                  # k+1 (implicit side).
    sc,           # (8, B): dt, r, q, K, is_call(0/1), american(0/1),
                  #         s_min, s_max
    *,
    n_space: int,
    n_time: int,
    w: float = 0.5,   # theta-scheme weight: CN = 1/2, implicit Euler = 1
    interpret: bool = False,
):
    """March the whole book backward n_time steps; returns V(t=0) as (n, B).

    The book is padded to whole blocks of options with copies of option 0
    and the padding stripped from the result.  Boundary treatment and step
    ordering match solvers/local_vol_pde.solve: explicit half-step at the
    OLD time level, implicit solve at the NEW one, Dirichlet overwrite at
    tau (both discounts), American floor.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = n_space
    B = pay.shape[-1]
    BB = _BLOCK_B
    Bp = -(-B // BB) * BB
    f32 = jnp.float32

    def kernel(pay_ref, bands_ref, sc_ref, V, Cb, Db):
        dt, r, q, K, call_f, amer_f, s_lo, s_hi = (
            sc_ref[k, :] for k in range(8))

        def init(i, _):
            V[i, :] = pay_ref[i, :]
            return None

        jax.lax.fori_loop(0, n, init, None)

        def step(t, _):
            # up: explicit half-step at level t, elimination at level t+1;
            # rows 0 and n-1 are identity rows (c = 0, d = V)
            def up(i, carry):
                c_prev, d_prev = carry
                Vc = V[i, :]
                LV = (bands_ref[t, i, :] * V[i - 1, :]
                      + bands_ref[t, n + i, :] * Vc
                      + bands_ref[t, 2 * n + i, :] * V[i + 1, :])
                rhs = Vc + ((1.0 - w) * dt) * LV
                li = -(w * dt) * bands_ref[t + 1, i, :]
                di = 1.0 - (w * dt) * bands_ref[t + 1, n + i, :]
                ui = -(w * dt) * bands_ref[t + 1, 2 * n + i, :]
                piv = 1.0 / (di - li * c_prev)
                c = ui * piv
                d = (rhs - li * d_prev) * piv
                Cb[i, :] = c
                Db[i, :] = d
                return c, d

            zero = jnp.zeros((BB,), f32)
            jax.lax.fori_loop(1, n - 1, up, (zero, V[0, :]))

            # down: back substitution, boundaries, American floor
            tau = dt * (t + 1).astype(f32)
            dfr = jnp.exp(-r * tau)
            dfq = jnp.exp(-q * tau)

            def floor(Vn, i):
                return Vn + amer_f * (jnp.maximum(Vn, pay_ref[i, :]) - Vn)

            x_last = V[n - 1, :]
            V[n - 1, :] = floor(call_f * (s_hi * dfq - K * dfr), n - 1)

            def down(k, x_next):
                i = n - 2 - k
                x = Db[i, :] - Cb[i, :] * x_next
                V[i, :] = floor(x, i)
                return x

            jax.lax.fori_loop(0, n - 2, down, x_last)
            V[0, :] = floor((1.0 - call_f) * (K * dfr - s_lo * dfq), 0)
            return None

        jax.lax.fori_loop(0, n_time, step, None)

    def pad(arr):
        arr = arr.astype(f32)
        reps = jnp.repeat(arr[..., :1], Bp - B, axis=-1)
        return jnp.concatenate([arr, reps], axis=-1)

    lane = lambda rows: pl.BlockSpec((rows, BB), lambda b: (0, b))
    V, _, _ = pl.pallas_call(
        kernel,
        grid=(Bp // BB,),
        out_shape=[jax.ShapeDtypeStruct((n, Bp), f32)] * 3,
        in_specs=[lane(n),
                  pl.BlockSpec((n_time + 1, 3 * n, BB), lambda b: (0, 0, b)),
                  lane(8)],
        out_specs=[lane(n)] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="local_vol_cn_march",
    )(pad(pay), pad(bands), pad(sc))
    return V[:, :B]
