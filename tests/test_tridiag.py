"""Tridiagonal solver tests: correctness vs dense solve, batching, Pallas kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_tpu.ops import tridiag


def dense_from_diags(lower, diag, upper):
    n = len(diag)
    a = np.zeros((n, n))
    for i in range(n):
        a[i, i] = diag[i]
        if i > 0:
            a[i, i - 1] = lower[i - 1]
        if i < n - 1:
            a[i, i + 1] = upper[i]
    return a


@pytest.fixture
def system(rng):
    n = 50
    lower = rng.uniform(-1, 1, n - 1)
    upper = rng.uniform(-1, 1, n - 1)
    diag = 4.0 + rng.uniform(0, 1, n)  # diagonally dominant
    rhs = rng.uniform(-2, 2, n)
    return lower, diag, upper, rhs


class TestThomas:
    def test_matches_dense_solve(self, system):
        lower, diag, upper, rhs = system
        x = tridiag.thomas(*map(jnp.asarray, system))
        expected = np.linalg.solve(dense_from_diags(lower, diag, upper), rhs)
        np.testing.assert_allclose(np.asarray(x), expected, rtol=1e-12)

    def test_identity(self):
        n = 10
        x = tridiag.thomas(jnp.zeros(n - 1), jnp.ones(n), jnp.zeros(n - 1), jnp.arange(n, dtype=float))
        np.testing.assert_allclose(np.asarray(x), np.arange(n, dtype=float))

    def test_batched(self, rng):
        B, n = 7, 30
        lower = rng.uniform(-1, 1, (B, n - 1))
        upper = rng.uniform(-1, 1, (B, n - 1))
        diag = 4.0 + rng.uniform(0, 1, (B, n))
        rhs = rng.uniform(-2, 2, (B, n))
        x = np.asarray(tridiag.thomas(*map(jnp.asarray, (lower, diag, upper, rhs))))
        for b in range(B):
            expected = np.linalg.solve(dense_from_diags(lower[b], diag[b], upper[b]), rhs[b])
            np.testing.assert_allclose(x[b], expected, rtol=1e-11)

    def test_broadcast_shared_operator(self, rng):
        """One operator, many right-hand sides (the ADI pattern)."""
        n = 20
        lower = jnp.asarray(rng.uniform(-1, 1, n - 1))
        upper = jnp.asarray(rng.uniform(-1, 1, n - 1))
        diag = jnp.asarray(4.0 + rng.uniform(0, 1, n))
        rhs = jnp.asarray(rng.uniform(-2, 2, (5, n)))
        x = tridiag.thomas(lower, diag, upper, rhs)
        assert x.shape == (5, n)
        one = tridiag.thomas(lower, diag, upper, rhs[2])
        np.testing.assert_allclose(np.asarray(x[2]), np.asarray(one), rtol=1e-13)

    def test_jit_vmap(self, rng):
        n = 16
        diag = jnp.asarray(4.0 + rng.uniform(0, 1, (4, n)))
        lower = jnp.asarray(rng.uniform(-1, 1, (4, n - 1)))
        upper = jnp.asarray(rng.uniform(-1, 1, (4, n - 1)))
        rhs = jnp.asarray(rng.uniform(-1, 1, (4, n)))
        direct = tridiag.thomas(lower, diag, upper, rhs)
        vmapped = jax.jit(jax.vmap(tridiag.thomas))(lower, diag, upper, rhs)
        np.testing.assert_allclose(np.asarray(direct), np.asarray(vmapped), rtol=1e-13)

    def test_gradient_flows(self, system):
        """The solver is differentiable (needed for AD through PDE prices)."""
        lower, diag, upper, rhs = map(jnp.asarray, system)

        def loss(d):
            return jnp.sum(tridiag.thomas(lower, d, upper, rhs) ** 2)

        g = jax.grad(loss)(diag)
        assert np.all(np.isfinite(np.asarray(g)))


class TestThomasFactored:
    """Factor-once API for time-independent marches: same solutions as
    :func:`thomas`, one elimination amortized over many right-hand sides."""

    def test_matches_thomas(self, system):
        lower, diag, upper, rhs = map(jnp.asarray, system)
        f = tridiag.thomas_factor(lower, diag, upper)
        x = tridiag.thomas_solve_factored(f, rhs)
        ref = tridiag.thomas(lower, diag, upper, rhs)
        np.testing.assert_allclose(np.asarray(x), np.asarray(ref), rtol=1e-12)

    def test_many_rhs_one_factorization(self, rng):
        n, R = 24, 6
        lower = jnp.asarray(rng.uniform(-1, 1, n - 1))
        upper = jnp.asarray(rng.uniform(-1, 1, n - 1))
        diag = jnp.asarray(4.0 + rng.uniform(0, 1, n))
        f = tridiag.thomas_factor(lower, diag, upper)
        for _ in range(R):
            rhs = jnp.asarray(rng.uniform(-2, 2, n))
            x = tridiag.thomas_solve_factored(f, rhs)
            ref = tridiag.thomas(lower, diag, upper, rhs)
            np.testing.assert_allclose(np.asarray(x), np.asarray(ref), rtol=1e-12)

    def test_batched_rhs_against_shared_factors(self, rng):
        """(B, n) right-hand sides broadcast against 1-D factors."""
        B, n = 5, 30
        lower = jnp.asarray(rng.uniform(-1, 1, n - 1))
        upper = jnp.asarray(rng.uniform(-1, 1, n - 1))
        diag = jnp.asarray(4.0 + rng.uniform(0, 1, n))
        rhs = jnp.asarray(rng.uniform(-2, 2, (B, n)))
        f = tridiag.thomas_factor(lower, diag, upper)
        x = np.asarray(tridiag.thomas_solve_factored(f, rhs))
        ref = np.asarray(tridiag.thomas(lower, diag, upper, rhs))
        np.testing.assert_allclose(x, ref, rtol=1e-12)

    def test_jittable_and_differentiable(self, system):
        lower, diag, upper, rhs = map(jnp.asarray, system)

        @jax.jit
        def solve_sum(r):
            f = tridiag.thomas_factor(lower, diag, upper)
            return jnp.sum(tridiag.thomas_solve_factored(f, r))

        g = jax.grad(solve_sum)(rhs)
        assert np.all(np.isfinite(np.asarray(g)))


class TestPCR:
    def test_matches_dense_solve(self, system):
        lower, diag, upper, rhs = system
        x = tridiag.pcr(*map(jnp.asarray, system))
        expected = np.linalg.solve(dense_from_diags(lower, diag, upper), rhs)
        np.testing.assert_allclose(np.asarray(x), expected, rtol=1e-10)

    @pytest.mark.parametrize("n", [2, 3, 7, 16, 100, 1023])
    def test_matches_thomas_all_sizes(self, rng, n):
        lower = rng.uniform(-0.3, 0.3, n - 1)
        upper = rng.uniform(-0.3, 0.3, n - 1)
        diag = 2.0 + rng.uniform(0, 1, n)
        rhs = rng.uniform(-2, 2, n)
        args = tuple(map(jnp.asarray, (lower, diag, upper, rhs)))
        np.testing.assert_allclose(
            np.asarray(tridiag.pcr(*args)), np.asarray(tridiag.thomas(*args)), atol=1e-12
        )

    def test_batched_broadcast(self, rng):
        lower = jnp.asarray(rng.uniform(-0.3, 0.3, (4, 5, 31)))
        upper = jnp.asarray(rng.uniform(-0.3, 0.3, (4, 5, 31)))
        diag = jnp.asarray(2.0 + rng.uniform(0, 1, (4, 5, 32)))
        rhs = jnp.asarray(rng.uniform(-2, 2, 32))  # shared rhs broadcasts
        np.testing.assert_allclose(
            np.asarray(tridiag.pcr(lower, diag, upper, rhs)),
            np.asarray(tridiag.thomas(lower, diag, upper, rhs)),
            atol=1e-12,
        )

    def test_jittable_and_differentiable(self, system):
        args = tuple(map(jnp.asarray, system))
        x_jit = jax.jit(tridiag.pcr)(*args)
        np.testing.assert_allclose(np.asarray(x_jit), np.asarray(tridiag.pcr(*args)))
        g = jax.grad(lambda d: jnp.sum(tridiag.pcr(args[0], d, args[2], args[3]) ** 2))(args[1])
        assert np.all(np.isfinite(np.asarray(g)))


class TestGtsv:
    """The block-diagonal ``lax.linalg.tridiagonal_solve`` route: same
    answers, vmap folding into one long system, and its custom gradient."""

    @pytest.mark.parametrize("B, n", [(1, 3), (7, 40), (70, 17)])
    def test_matches_thomas(self, rng, B, n):
        lower = rng.uniform(-1, 1, (B, n - 1))
        upper = rng.uniform(-1, 1, (B, n - 1))
        diag = 4.0 + rng.uniform(0, 1, (B, n))
        rhs = rng.uniform(-2, 2, (B, n))
        args = tuple(map(jnp.asarray, (lower, diag, upper, rhs)))
        np.testing.assert_allclose(np.asarray(tridiag.gtsv(*args)),
                                   np.asarray(tridiag.thomas(*args)),
                                   rtol=1e-12, atol=1e-12)

    def test_shared_bands_and_vmap(self, rng):
        """1-D bands shared by every system (heston_adi's v-sweep pattern),
        and a vmapped call, both fold into one block-diagonal solve."""
        B, n = 6, 24
        lower = jnp.asarray(rng.uniform(-1, 1, n - 1))
        upper = jnp.asarray(rng.uniform(-1, 1, n - 1))
        diag = jnp.asarray(4 + rng.uniform(0, 1, n))
        rhs = jnp.asarray(rng.uniform(-1, 1, (3, B, n)))
        ref = tridiag.thomas(lower, diag, upper, rhs)
        np.testing.assert_allclose(
            np.asarray(tridiag.gtsv(lower, diag, upper, rhs)),
            np.asarray(ref), rtol=1e-12, atol=1e-12)
        out = jax.vmap(lambda b: tridiag.gtsv(lower, diag, upper, b))(rhs)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("argnum", [0, 1, 2, 3])
    def test_gradient_matches_thomas(self, system, argnum):
        args = tuple(map(jnp.asarray, system))

        def loss(solver, a):
            full = list(args)
            full[argnum] = a
            return jnp.sum(jnp.sin(solver(*full)))

        g_ref = jax.grad(lambda a: loss(tridiag.thomas, a))(args[argnum])
        g = jax.grad(lambda a: loss(tridiag.gtsv, a))(args[argnum])
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=1e-9, atol=1e-12)

    def test_gradient_under_vmap(self, rng):
        B, n = 4, 12
        lower = jnp.asarray(rng.uniform(-1, 0, (B, n - 1)))
        upper = jnp.asarray(rng.uniform(-1, 0, (B, n - 1)))
        diag = jnp.asarray(3 + rng.uniform(0, 1, (B, n)))
        rhs = jnp.asarray(rng.normal(size=(B, n)))

        def loss(solver, d):
            return jnp.sum(jax.vmap(solver)(lower, d, upper, rhs) ** 2)

        np.testing.assert_allclose(
            np.asarray(jax.grad(lambda d: loss(tridiag.gtsv, d))(diag)),
            np.asarray(jax.grad(lambda d: loss(tridiag.thomas, d))(diag)),
            rtol=1e-9, atol=1e-12)


class TestDispatcher:
    def test_shared_bands_broadcast(self, rng):
        """tridiagonal_solve accepts the shared-1D-bands pattern
        (heston_adi's v-sweep) and returns per-system solutions."""
        B, n = 6, 24
        lower = jnp.asarray(rng.uniform(-1, 1, n - 1))
        upper = jnp.asarray(rng.uniform(-1, 1, n - 1))
        diag = jnp.asarray(4 + rng.uniform(0, 1, n))
        rhs = jnp.asarray(rng.uniform(-1, 1, (B, n)), dtype=jnp.float32)
        ref = tridiag.thomas(lower, diag, upper, rhs)
        out = tridiag.tridiagonal_solve(
            lower.astype(jnp.float32), diag.astype(jnp.float32),
            upper.astype(jnp.float32), rhs)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-4, atol=1e-5)

    @pytest.mark.parametrize("dtype, route", [
        (jnp.float32, "gtsv"), (jnp.float64, "gtsv"),
        (jnp.bfloat16, "thomas"), (jnp.float16, "thomas")])
    @pytest.mark.parametrize("shape", [(8192,), (512, 200)])
    def test_choice_follows_dtype(self, monkeypatch, dtype, route, shape):
        """The route is read from the dtype alone, on every backend and
        for long single systems as for wide batches."""
        called = []
        for name in ("gtsv", "thomas"):
            monkeypatch.setattr(
                tridiag, name,
                lambda *a, _n=name: called.append(_n) or a[-1])
        n = shape[-1]
        rhs = jnp.zeros(shape, dtype)
        tridiag.tridiagonal_solve(jnp.zeros(n - 1, dtype), jnp.ones(n, dtype),
                                  jnp.zeros(n - 1, dtype), rhs)
        assert called == [route]
