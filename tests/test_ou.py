"""OU process tests: golden MLE parity on the reference path + recovery tests
(cf. tests/cpp/test_ou_process.cpp)."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_tpu.models import ou
from pde_tpu.models.ou import OUParams

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" / "reference_values.json").read_text())


@pytest.fixture(scope="module")
def params():
    return OUParams(theta=100.0, mu=5.0, sigma=2.0)


@pytest.fixture(scope="module")
def ref_path():
    """The exact mt19937-seeded path the reference fit was computed on."""
    return np.array(GOLDEN["ou_path"])


class TestGoldenParity:
    def test_fit_mle_matches_cpp(self, ref_path):
        """fit_mle reproduces OUProcess::fit_mle on the same input series."""
        res = ou.fit_mle(jnp.asarray(ref_path), 1.0 / 252.0)
        # tolerances allow f64 summation-order differences (jnp pairwise vs
        # the C++ sequential accumulation)
        assert abs(float(res.params.theta) - GOLDEN["ou_fit_theta"]) < 1e-8
        assert abs(float(res.params.mu) - GOLDEN["ou_fit_mu"]) < 1e-6
        assert abs(float(res.params.sigma) - GOLDEN["ou_fit_sigma"]) < 1e-8
        assert abs(float(res.log_likelihood) - GOLDEN["ou_fit_ll"]) < 1e-6
        assert abs(float(res.aic) - GOLDEN["ou_fit_aic"]) < 1e-6
        assert abs(float(res.bic) - GOLDEN["ou_fit_bic"]) < 1e-6
        assert bool(res.converged)

    def test_log_likelihood_parity(self, ref_path, params):
        ll = ou.log_likelihood(jnp.asarray(ref_path), params, 1.0 / 252.0)
        assert abs(float(ll) - GOLDEN["ou_ll_true_params"]) < 1e-6

    def test_conditional_moments_parity(self, params):
        m = ou.conditional_mean(103.0, params, 1.0 / 252.0)
        assert abs(float(m) - GOLDEN["ou_cond_mean"]) < 1e-12
        v = ou.conditional_variance(params, 1.0 / 252.0)
        assert abs(float(v) - GOLDEN["ou_cond_var"]) < 1e-14

    def test_transition_density_parity(self, params):
        d = ou.transition_density(100.5, 103.0, params, 1.0 / 252.0)
        assert abs(float(d) - GOLDEN["ou_trans_dens"]) < 1e-90

    def test_boundaries_parity(self, params):
        lo, hi, ex = ou.optimal_boundaries(params, 0.001, 0.05)
        assert abs(float(lo) - GOLDEN["ou_bound_lower"]) < 1e-10
        assert abs(float(hi) - GOLDEN["ou_bound_upper"]) < 1e-10
        assert abs(float(ex) - GOLDEN["ou_bound_exit"]) < 1e-10


class TestRecovery:
    def test_mle_recovers_parameters(self, params):
        """Long simulated path: MLE recovers the generating parameters
        (test_ou_process.cpp MLE recovery pattern)."""
        key = jax.random.PRNGKey(7)
        path = ou.simulate(params, 100.0, 20.0, 5040, key)
        res = ou.fit_mle(path, 20.0 / 5040)
        assert abs(float(res.params.theta) - 100.0) < 0.5
        assert abs(float(res.params.mu) - 5.0) / 5.0 < 0.5
        assert abs(float(res.params.sigma) - 2.0) / 2.0 < 0.1

    def test_vmapped_fit_over_spreads(self, params):
        """Batch-fit many spreads in one jitted call — the batched replacement
        for the per-pair Python loop."""
        keys = jax.random.split(jax.random.PRNGKey(3), 8)
        paths = jax.vmap(lambda k: ou.simulate(params, 100.0, 4.0, 1008, k))(keys)
        res = jax.jit(jax.vmap(lambda p: ou.fit_mle(p, 4.0 / 1008)))(paths)
        assert res.params.theta.shape == (8,)
        assert np.all(np.abs(np.asarray(res.params.theta) - 100.0) < 2.0)

    def test_constant_series_degenerate(self):
        res = ou.fit_mle(jnp.full(50, 7.0), 1.0 / 252.0)
        assert not bool(res.converged)
        assert abs(float(res.params.theta) - 7.0) < 1e-12
        assert float(res.params.sigma) == 0.0


class TestSimulation:
    def test_path_shape_and_start(self, params):
        path = ou.simulate(params, 95.0, 1.0, 252, jax.random.PRNGKey(0))
        assert path.shape == (253,)
        assert float(path[0]) == 95.0

    def test_stationary_statistics(self, params):
        """Long-run mean/std match the stationary distribution."""
        keys = jax.random.split(jax.random.PRNGKey(11), 64)
        paths = jax.vmap(lambda k: ou.simulate(params, 100.0, 8.0, 2016, k))(keys)
        tail = np.asarray(paths[:, 1000:])
        assert abs(tail.mean() - 100.0) < 0.1
        stat_std = float(params.stationary_std())
        assert abs(tail.std() - stat_std) / stat_std < 0.1

    def test_half_life(self, params):
        assert abs(float(params.half_life()) - np.log(2) / 5.0) < 1e-12

    @pytest.mark.slow
    def test_parallel_matches_scan(self, params):
        """simulate_parallel is the same recurrence reassociated: same key
        gives the same path to float roundoff, at log instead of linear
        depth."""
        key = jax.random.PRNGKey(3)
        a = ou.simulate(params, 95.0, 1.0, 512, key)
        b = ou.simulate_parallel(params, 95.0, 1.0, 512, key)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-9)
        assert float(b[0]) == 95.0


class TestSignals:
    def test_signal_walk(self, params):
        lo, hi, ex = ou.optimal_boundaries(params, 0.001)
        prices = jnp.array([100.0, float(lo) - 0.5, float(lo) - 0.2, 99.5, float(ex) + 0.1, 100.0])
        out = ou.generate_trading_signals(prices, params, 0.001)
        sig = np.asarray(out["signals"])
        assert sig[0] == 0  # neutral at mean
        assert sig[1] == 1  # entered long below lower boundary
        assert sig[2] == 1  # stays long
        assert sig[4] == 0  # exited at target
        assert sig[5] == 0

    def test_short_side(self, params):
        lo, hi, ex = ou.optimal_boundaries(params, 0.001)
        prices = jnp.array([float(hi) + 0.5, float(hi) + 0.1, float(ex) - 0.1])
        out = ou.generate_trading_signals(prices, params, 0.001)
        sig = np.asarray(out["signals"])
        assert sig[0] == -1
        assert sig[1] == -1
        assert sig[2] == 0
