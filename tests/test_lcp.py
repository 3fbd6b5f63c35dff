"""PSOR/LCP tests: complementarity correctness, American pricing, Leung-Li
free-boundary parity with the projection scheme."""

import jax.numpy as jnp
import numpy as np
import pytest

from pde_tpu.solvers import bs_pde, hjb
from pde_tpu.solvers.lcp import projected_sor


def dense(lower, diag, upper):
    n = len(diag)
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = diag[i]
        if i:
            A[i, i - 1] = lower[i - 1]
        if i < n - 1:
            A[i, i + 1] = upper[i]
    return A


class TestProjectedSOR:
    def test_unconstrained_matches_linear_solve(self, rng):
        n = 60
        lower = rng.uniform(-0.3, 0.0, n - 1)
        upper = rng.uniform(-0.3, 0.0, n - 1)
        diag = 2.0 + rng.uniform(0, 0.5, n)  # M-matrix: PSOR converges
        b = rng.uniform(0.5, 1.5, n)
        g = np.full(n, -1e6)  # obstacle never binds
        x, resid = projected_sor(
            jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper),
            jnp.asarray(b), jnp.asarray(g), n_iter=300,
        )
        expected = np.linalg.solve(dense(lower, diag, upper), b)
        np.testing.assert_allclose(np.asarray(x), expected, atol=1e-8)
        assert float(resid) < 1e-8

    def test_complementarity_conditions(self, rng):
        """x >= g, Ax >= b (componentwise where x > g), (x-g)(Ax-b) ~ 0."""
        n = 80
        lower = np.full(n - 1, -1.0)
        upper = np.full(n - 1, -1.0)
        diag = np.full(n, 2.5)
        b = rng.uniform(-1, 1, n)
        g = rng.uniform(-0.5, 0.5, n)
        x, resid = projected_sor(
            *map(jnp.asarray, (lower, diag, upper, b, g)), n_iter=400
        )
        x = np.asarray(x)
        A = dense(lower, diag, upper)
        Ax_b = A @ x - b
        assert np.all(x >= g - 1e-9)
        assert np.all(Ax_b >= -1e-7)
        assert np.max(np.abs(np.minimum(Ax_b, x - g))) < 1e-7
        assert float(resid) < 1e-7

    def test_batched(self, rng):
        n, B = 50, 4
        lower = np.full((B, n - 1), -1.0)
        upper = np.full((B, n - 1), -1.0)
        diag = np.full((B, n), 3.0)
        b = rng.uniform(-1, 1, (B, n))
        g = np.zeros((B, n))
        x, _ = projected_sor(*map(jnp.asarray, (lower, diag, upper, b, g)), n_iter=200)
        assert x.shape == (B, n)
        assert np.all(np.asarray(x) >= -1e-9)


class TestAmericanPSOR:
    def test_psor_vs_projection_close_and_above_european(self):
        base = bs_pde.BSPDEParams(sigma=0.25, r=0.08, T=1.0, K=110.0, is_call=False)
        eu = float(bs_pde.solve(base, 100.0).price)
        proj = float(bs_pde.solve(base._replace(american=True), 100.0).price)
        psor = float(
            bs_pde.solve(
                base._replace(american=True, american_method="psor", psor_iterations=80),
                100.0,
            ).price
        )
        assert psor >= eu
        # PSOR solves the true LCP; projection splitting is a close approximation
        assert abs(psor - proj) < 0.05
        # the rigorous LCP value dominates the splitting approximation
        assert psor >= proj - 1e-6

    def test_psor_never_below_intrinsic(self):
        p = bs_pde.BSPDEParams(
            sigma=0.2, r=0.05, T=1.0, K=120.0, is_call=False,
            american=True, american_method="psor",
        )
        res = bs_pde.solve(p, 100.0)
        intrinsic = np.maximum(120.0 - np.asarray(res.spot_grid), 0.0)
        assert np.all(np.asarray(res.prices) >= intrinsic - 1e-6)


class TestHJBPSOR:
    def test_psor_boundaries_consistent_with_projection(self):
        base = hjb.HJBParams(theta=0.0, mu=5.0, sigma=0.1, r=0.05, T=1.0)
        proj = hjb.solve_all_boundaries(base)
        psor = hjb.solve_all_boundaries(base._replace(method="psor", psor_iterations=80))
        assert abs(psor.entry_long - proj.entry_long) < 0.02
        assert abs(psor.entry_short - proj.entry_short) < 0.02
        assert psor.entry_long < psor.exit_long
        assert psor.exit_short < psor.entry_short

    def test_psor_value_dominates_exercise(self):
        p = hjb.HJBParams(method="psor")
        res = hjb.solve(p)
        g = np.asarray(hjb._exercise_value(jnp.asarray(res.x_grid), p, p.problem))
        assert np.all(res.value_function >= g - 1e-6)


class TestPSORAgainstExactLCP:
    @pytest.mark.parametrize("B, n", [(1, 16), (5, 64), (3, 127)])
    def test_psor_converges_to_brennan_schwartz(self, rng, B, n):
        """Red-black PSOR reaches the exact one-pass LCP solution on
        batches of put-shaped obstacle problems (exercise region on the
        left), ragged lengths included."""
        from pde_tpu.solvers.lcp import brennan_schwartz, projected_sor

        lower = np.broadcast_to(-rng.uniform(0.1, 0.4, (B, 1)), (B, n - 1))
        upper = np.broadcast_to(-rng.uniform(0.1, 0.4, (B, 1)), (B, n - 1))
        diag = np.broadcast_to(1.05 - lower[:, :1] - upper[:, :1], (B, n))
        g = np.broadcast_to(np.maximum(0.0, np.linspace(1.0, -1.0, n)), (B, n))
        b = np.full((B, n), 0.01)
        args = tuple(map(jnp.asarray, (lower, diag, upper, b, g)))
        x_ex, r_ex = brennan_schwartz(*args)
        x_ps, r_ps = projected_sor(*args, n_iter=400)
        assert float(r_ex) < 1e-10
        np.testing.assert_allclose(np.asarray(x_ps), np.asarray(x_ex),
                                   atol=1e-6)


class TestBrennanSchwartz:
    """Exact one-pass LCP solve (lcp.brennan_schwartz) and its HJB wiring."""

    def test_matches_psor_all_problems_both_directions(self):
        base = hjb.HJBParams(
            c_entry=0.002, c_exit=0.002, n_space=256, n_time=128,
            backend="device",
        )
        for pr in hjb.StoppingProblem:
            r_ps = hjb.solve(base._replace(problem=pr, method="psor",
                                           psor_iterations=200))
            r_bs = hjb.solve(base._replace(problem=pr,
                                           method="brennan_schwartz"))
            np.testing.assert_allclose(
                r_bs.value_function, r_ps.value_function, atol=1e-10)
            assert r_bs.lower_boundary == r_ps.lower_boundary
            assert r_bs.upper_boundary == r_ps.upper_boundary

    def test_factor_apply_matches_one_shot(self, rng):
        """brennan_schwartz_factor + _apply == brennan_schwartz, both sweep
        directions, shared factors across many right-hand sides (the
        obstacle-march usage pattern)."""
        from pde_tpu.solvers.lcp import (brennan_schwartz,
                                         brennan_schwartz_apply,
                                         brennan_schwartz_factor)

        n = 40
        lower = jnp.asarray(-rng.uniform(0.1, 0.5, n - 1))
        upper = jnp.asarray(-rng.uniform(0.1, 0.5, n - 1))
        diag = jnp.asarray(2.0 + rng.uniform(0, 1, n))  # M-matrix
        g = jnp.asarray(np.maximum(1.0 - np.linspace(0, 2, n), 0.0))
        for reverse in (False, True):
            f = brennan_schwartz_factor(lower, diag, upper, reverse=reverse)
            for _ in range(3):
                b = jnp.asarray(rng.uniform(0.0, 1.0, n))
                x = brennan_schwartz_apply(f, b, g)
                x_ref, _ = brennan_schwartz(lower, diag, upper, b, g,
                                            reverse=reverse)
                np.testing.assert_allclose(
                    np.asarray(x), np.asarray(x_ref), rtol=1e-12, atol=1e-14)

    def test_native_backend_matches_device(self):
        from pde_tpu import native

        if not native.is_available():
            import pytest
            pytest.skip("native library unavailable")
        p = hjb.HJBParams(c_entry=0.002, c_exit=0.002, n_space=256,
                          n_time=128, method="brennan_schwartz")
        b_native = hjb.solve_all_boundaries(p)  # auto routes native
        b_device = hjb.solve_all_boundaries(p._replace(backend="device"))
        for f in b_native._fields:
            assert abs(getattr(b_native, f) - getattr(b_device, f)) < 1e-9, f

    def test_boundaries_batch_matches_single(self):
        B = 4
        mu = np.linspace(2.0, 8.0, B)
        sigma = np.linspace(0.05, 0.2, B)
        x, V, g = hjb.boundaries_batch(
            theta=jnp.zeros(B), mu=jnp.asarray(mu), sigma=jnp.asarray(sigma),
            r=0.05, c_entry=0.002, c_exit=0.002, T=1.0,
            n_space=128, n_time=64)
        batch = hjb.extract_boundaries_batch(x, V, g, mu, sigma, np.zeros(B))
        for b_idx in (0, B - 1):
            ss = sigma[b_idx] / np.sqrt(2.0 * mu[b_idx])
            single = hjb.solve_all_boundaries(hjb.HJBParams(
                theta=0.0, mu=mu[b_idx], sigma=sigma[b_idx], r=0.05,
                c_entry=0.002, c_exit=0.002, T=1.0, n_space=128, n_time=64,
                x_min=-15.8 * ss, x_max=15.8 * ss,
                method="brennan_schwartz", backend="device"))
            # 1e-12: the single path builds its grid host-side (np.linspace)
            # while the batch path uses jnp.linspace -- 1-ulp grid skew
            assert batch[b_idx].entry_long == pytest.approx(
                single.entry_long, abs=1e-12)
            assert batch[b_idx].entry_short == pytest.approx(
                single.entry_short, abs=1e-12)
