"""Fused Douglas ADI march for an option book — one Pallas (Triton) kernel.

The XLA formulation (:func:`pde_tpu.solvers.heston_adi.solve_batch`) runs
the time march as a ``lax.scan`` whose Thomas sweeps are ``lax.scan`` s
themselves: on a GPU every sweep row is its own small kernel, about
n_time * 2 * (n_spot + n_vol) dependent launches per book.  This kernel
runs the whole march of ONE option inside one program (one CTA): the
mixed-derivative stencil, both implicit sweeps, the Dirichlet boundaries
and the American projection / Ikonen-Toivanen multiplier update, for all
n_time steps, with no return to the host between steps.  The grid is one
program per option, so a 512-option book spreads over every SM.

Layout.  Each option owns flat float32 buffers in device memory (hot in
L1/L2 while its program runs) holding the (nS, nv) grid inside a one-cell
zero halo: node (i, j) lives at ``(i + 1) * C + (j + 1)`` with
``C = next_pow2(nv + 2)``.  A grid row is a ``C``-wide contiguous window,
a grid column an ``NSP = next_pow2(nS)``-long window of stride ``C``, and
the halo turns every stencil neighbour into a shifted window (Triton
tensors have power-of-two sizes; masks keep stores inside the real grid).
Each time step has four phases:

1. rows i = 0..nS-1: explicit operators with the S-direction Thomas
   elimination fused in (the carry is the previous row);
2. rows i = nS-1..0: S back substitution, forming the v-sweep right side;
3. columns j = 0..nv-1: v-direction elimination;
4. columns j = nv-1..0: v back substitution, boundaries, exercise.

Row and column phases reach the same buffer through different threads, so
a CTA barrier separates the phases.  The barrier has no interpreter rule;
``interpret=True`` runs each program serially, where none is needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["fused_douglas_march_batched", "adi_layout"]

# warps per program: row phases carry C <= 64 lanes, column phases NSP
# <= 128, so four warps cover a column with one element per thread
_NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def adi_layout(n_spot: int, n_vol: int):
    """``(NSP, C, F)``: padded row count, row stride, flat buffer length."""
    nsp = _next_pow2(n_spot)
    c = _next_pow2(n_vol + 2)
    return nsp, c, (nsp + 3) * c


@functools.partial(
    jax.jit,
    static_argnames=("n_spot", "n_vol", "n_time", "use_it", "interpret"),
)
def fused_douglas_march_batched(
    pay,    # (B, NSP) payoff of row i on the option's own K-scaled grid
    sg,     # (B, NSP) spot level of row i
    a1b,    # (B, 4, C) explicit S-operator interior rows [lo, di, up, 0] by j
    i1b,    # (B, 4, C) implicit S-system interior rows [lo, di, up, 0] by j
    a2b,    # (B, 4, C) explicit v-operator bands, row-aligned, edges baked in
    i2b,    # (B, 4, C) implicit v-system bands (identity row at j = nv-1)
    mixb,   # (B, C) mixed-derivative coefficient, zero at both j edges
    sc,     # (B, 8): dt, r, q, K, is_call(0/1), american(0/1), 0, 0
    *,
    n_spot: int,
    n_vol: int,
    n_time: int,
    use_it: bool = False,
    interpret: bool = False,
):
    """March a whole book; returns the t=0 grids as ``(B, nS, nv)``.

    Per-option inputs enter zero-padded to the widths of
    :func:`adi_layout` (beyond ``n_spot`` rows and ``n_vol`` columns).
    ``use_it`` selects the Ikonen-Toivanen multiplier treatment for the
    options flagged American (static: it adds the multiplier buffer);
    otherwise flagged options are projected on the payoff every step.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    nS, nv, nT = n_spot, n_vol, n_time
    NSP, C, F = adi_layout(nS, nv)
    B = pay.shape[0]
    f32 = jnp.float32
    th = 0.5  # Douglas parameter

    def barrier():
        if not interpret:
            plgpu.debug_barrier()

    def kernel(pay_ref, sg_ref, a1_ref, i1_ref, a2_ref, i2_ref, mix_ref,
               sc_ref, V, D, R, C1, C2, *lam):
        LAM = lam[0] if use_it else None
        dt = sc_ref[0]
        r = sc_ref[1]
        q = sc_ref[2]
        K = sc_ref[3]
        call_f = sc_ref[4]
        amer_f = sc_ref[5]

        jmask = jnp.arange(C) < nv              # real nodes of a row window
        irow = jnp.arange(NSP)
        imask = irow < nS                       # real nodes of a column
        col_off = C + 1 + irow * C              # column-window offsets, j = 0
        g_col = pay_ref[...]                    # (NSP,) payoff by row
        sg_col = sg_ref[...]
        a1L, a1D, a1U = a1_ref[0, :], a1_ref[1, :], a1_ref[2, :]
        i1L, i1D, i1U = i1_ref[0, :], i1_ref[1, :], i1_ref[2, :]
        a2L, a2D, a2U = a2_ref[0, :], a2_ref[1, :], a2_ref[2, :]
        mix = mix_ref[...]

        def row(buf, i, dj=0, di=0):            # nodes (i + di, j + dj)
            return buf.at[pl.ds((i + 1 + di) * C + 1 + dj, C)]

        def col(buf, j):                        # nodes (i, j), i < NSP
            return buf.at[col_off + j]

        zeros_c = jnp.zeros((C,), f32)
        bufs = (V, D, R, C1) + ((LAM,) if use_it else ())

        def clear(k, _):
            for b in bufs:
                b[pl.ds(k * C, C)] = zeros_c
            return None

        jax.lax.fori_loop(0, F // C, clear, None)
        C2[...] = zeros_c
        barrier()

        def init_row(i, _):
            plgpu.store(row(V, i), jnp.full((C,), pay_ref[i], f32),
                        mask=jmask)
            return None

        jax.lax.fori_loop(0, nS, init_row, None)
        barrier()

        def step(t, _):
            # phase 1: explicit operators + S elimination, rows ascending
            def fwd_s(i, carry):
                c_prev, d_prev = carry
                Vc = row(V, i)[...]
                Vl = row(V, i, dj=-1)[...]
                Vr = row(V, i, dj=1)[...]
                Vd = row(V, i, di=-1)[...]
                Vu = row(V, i, di=1)[...]
                Vxv = (row(V, i, 1, 1)[...] - row(V, i, -1, 1)[...]
                       - row(V, i, 1, -1)[...] + row(V, i, -1, -1)[...])
                inner = ((i > 0) & (i < nS - 1)).astype(f32)
                a1V = inner * (a1D * Vc + a1L * Vd + a1U * Vu)
                a2V = a2D * Vc + a2L * Vl + a2U * Vr
                rhs = (Vc + dt * (inner * mix * Vxv)
                       + ((1.0 - th) * dt) * a1V + dt * a2V)
                if use_it:
                    rhs = rhs + dt * row(LAM, i)[...]
                # rows 0 and nS-1 are identity rows of the S system
                li = i1L * inner
                dg = i1D * inner + (1.0 - inner)
                ui = i1U * inner
                inv = 1.0 / (dg - li * c_prev)
                c = ui * inv
                d = (rhs - li * d_prev) * inv
                plgpu.store(row(D, i), d, mask=jmask)
                plgpu.store(row(C1, i), c, mask=jmask)
                plgpu.store(row(R, i), a2V, mask=jmask)
                return c, d

            jax.lax.fori_loop(0, nS, fwd_s, (zeros_c, zeros_c))
            barrier()

            # phase 2: S back substitution; right side of the v system
            def bwd_s(k, y_next):
                i = nS - 1 - k
                y = row(D, i)[...] - row(C1, i)[...] * y_next
                plgpu.store(row(R, i), y - (th * dt) * row(R, i)[...],
                            mask=jmask)
                return y

            jax.lax.fori_loop(0, nS, bwd_s, zeros_c)
            barrier()

            # phase 3: v elimination, columns ascending
            zeros_r = jnp.zeros((NSP,), f32)

            def fwd_v(j, carry):
                c_prev, d_prev = carry
                lj = i2_ref[0, j]
                inv = 1.0 / (i2_ref[1, j] - lj * c_prev)
                c = i2_ref[2, j] * inv
                d = (col(R, j)[...] - lj * d_prev) * inv
                plgpu.store(col(D, j), d, mask=imask)
                C2[j] = c
                return c, d

            jax.lax.fori_loop(0, nv, fwd_v, (jnp.zeros((), f32), zeros_r))
            barrier()

            # phase 4: v back substitution, exercise, boundaries
            tau = dt * (t + 1).astype(f32)
            dfr = jnp.exp(-r * tau)
            dfq = jnp.exp(-q * tau)
            bc0 = (1.0 - call_f) * (K * dfr - sg_ref[0] * dfq)
            bcN = call_f * (sg_ref[nS - 1] * dfq - K * dfr)
            bcV = call_f * (sg_col * dfq) + (1.0 - call_f) * (K * dfr)
            i_edge = (irow == 0) | (irow == nS - 1)

            def bwd_v(k, x_next):
                j = nv - 1 - k
                x = col(D, j)[...] - C2[j] * x_next
                Vn = x
                if use_it:
                    lam_c = col(LAM, j)[...]
                    W = Vn - dt * lam_c
                    V_it = jnp.maximum(g_col, W)
                    plgpu.store(
                        col(LAM, j),
                        amer_f * ((V_it - W) / dt) + (1.0 - amer_f) * lam_c,
                        mask=imask)
                    Vn = amer_f * V_it + (1.0 - amer_f) * Vn
                Vn = jnp.where(irow == 0, bc0, Vn)
                Vn = jnp.where(irow == nS - 1, bcN, Vn)
                Vn = jnp.where(j == nv - 1, bcV, Vn)
                if use_it:
                    edge = i_edge | (j == 0) | (j == nv - 1)
                    w = jnp.where(edge, amer_f, 0.0)
                else:
                    w = amer_f
                Vn = Vn + w * (jnp.maximum(Vn, g_col) - Vn)
                plgpu.store(col(V, j), Vn, mask=imask)
                return x

            jax.lax.fori_loop(0, nv, bwd_v, zeros_r)
            barrier()
            return None

        jax.lax.fori_loop(0, nT, step, None)

    per_opt = lambda *shape: pl.BlockSpec(
        (None,) + shape, lambda b: (b,) + (0,) * len(shape))
    n_buf = 5 if use_it else 4
    outs = pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=[jax.ShapeDtypeStruct((B, F), f32)] * 4
                  + [jax.ShapeDtypeStruct((B, C), f32)]
                  + [jax.ShapeDtypeStruct((B, F), f32)] * (n_buf - 4),
        in_specs=[per_opt(NSP), per_opt(NSP)] + [per_opt(4, C)] * 4
                 + [per_opt(C), per_opt(8)],
        out_specs=[per_opt(F)] * 4 + [per_opt(C)]
                  + [per_opt(F)] * (n_buf - 4),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="heston_adi_march",
    )(*(a.astype(f32) for a in (pay, sg, a1b, i1b, a2b, i2b, mixb, sc)))
    V = outs[0][:, : (NSP + 2) * C].reshape(B, NSP + 2, C)
    return V[:, 1:nS + 1, 1:nv + 1]
