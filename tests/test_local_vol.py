"""Dupire local volatility: AD extraction + local-vol PDE consistency.

The flagship check is the classic Dupire round trip: Heston CF prices ->
local-vol surface by AD -> the local-vol PDE re-prices the generating
model's vanillas.  Flat-surface degenerations pin each piece independently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pde_tpu.models import black_scholes as bs
from pde_tpu.models import heston, local_vol
from pde_tpu.models.bates import BatesParams
from pde_tpu.models.heston import HestonParams
from pde_tpu.solvers import bs_pde, local_vol_pde

HP = HestonParams(kappa=2.0, theta=0.04, sigma=0.4, rho=-0.6, v0=0.05)
S0, R, Q = 100.0, 0.04, 0.01


class TestDupireExtraction:
    def test_flat_bs_price_surface_recovers_sigma(self):
        """AD Dupire on a constant-vol Black-Scholes call surface must
        return that vol at every (K, T)."""
        sig = 0.2

        def price_fn(K, T):
            return bs.price(S0, K, R, Q, T, sig, is_call=True)

        for K in (80.0, 100.0, 125.0):
            for T in (0.1, 0.5, 1.5):
                lv = float(local_vol.local_vol_from_price_fn(
                    price_fn, K, T, R, Q))
                np.testing.assert_allclose(lv, sig, rtol=1e-6)

    def test_flat_implied_surface_recovers_sigma(self):
        """Gatheral implied-variance form on a flat IV surface."""
        sig = 0.25
        iv_fn = lambda K, T: jnp.asarray(sig)  # noqa: E731
        for K in (85.0, 100.0, 120.0):
            lv = float(local_vol.local_vol_from_implied_fn(
                iv_fn, K, 0.75, S0, R, Q))
            np.testing.assert_allclose(lv, sig, rtol=1e-8)

    @pytest.mark.slow
    def test_price_and_implied_forms_agree_on_heston(self):
        """Both Dupire forms on the SAME Heston surface must agree — the
        price form differentiates the CF quadrature, the implied form the
        IV surface (price -> BS inversion -> AD), so agreement is a strong
        mutual check."""
        def price_fn(K, T):
            return heston.price_carr_madan_gl(HP, K, T, S0, R, Q)

        def iv_fn(K, T):
            return heston.implied_volatility(HP, K, T, S0, R, Q)

        for K, T in ((90.0, 0.5), (100.0, 0.5), (110.0, 1.0)):
            lv_p = float(local_vol.local_vol_from_price_fn(
                price_fn, K, T, R, Q))
            lv_i = float(local_vol.local_vol_from_implied_fn(
                iv_fn, K, T, S0, R, Q))
            np.testing.assert_allclose(lv_p, lv_i, rtol=2e-3)

    def test_heston_skew_shape(self):
        """Heston with rho < 0: local vol must decrease in strike around
        the money (the leverage skew)."""
        Ks = jnp.asarray([80.0, 90.0, 100.0, 110.0, 120.0])
        surf = np.asarray(local_vol.dupire_surface(
            HP, Ks, jnp.asarray([0.5]), S0, R, Q))[0]
        assert np.all(np.diff(surf) < 0), surf

    def test_bates_jumps_steepen_short_skew(self):
        """Downward jumps load the short-maturity OTM-put wing: the Bates
        local vol there must exceed the pure diffusion's."""
        bp = BatesParams(HP.kappa, HP.theta, HP.sigma, HP.rho, HP.v0,
                         lam=0.8, mu_j=-0.15, sigma_j=0.15)
        Ks = jnp.asarray([75.0, 80.0])
        Ts = jnp.asarray([0.15])
        lv_b = np.asarray(local_vol.dupire_surface(bp, Ks, Ts, S0, R, Q))
        lv_h = np.asarray(local_vol.dupire_surface(HP, Ks, Ts, S0, R, Q))
        assert np.all(np.isfinite(lv_b)) and np.all(lv_b > 0)
        assert np.all(lv_b > lv_h), (lv_b, lv_h)


class TestSurfaceInterpolator:
    def test_bilinear_exact_on_nodes_and_monotone_between(self):
        Ks = np.array([80.0, 100.0, 125.0])
        Ts = np.array([0.25, 1.0])
        grid = np.array([[0.30, 0.22, 0.18], [0.28, 0.21, 0.19]])
        interp = local_vol.SurfaceInterpolator(Ks, Ts, grid)
        for i, T in enumerate(Ts):
            vals = np.asarray(interp(jnp.asarray(Ks), T))
            np.testing.assert_allclose(vals, grid[i], rtol=1e-6)
        mid = float(interp(jnp.asarray([90.0]), 0.25)[0])
        assert 0.22 < mid < 0.30
        # flat extrapolation outside the grid
        np.testing.assert_allclose(
            float(interp(jnp.asarray([40.0]), 2.0)[0]), grid[1, 0], rtol=1e-6)


class TestLocalVolMC:
    def test_flat_surface_matches_black_scholes(self):
        sig = 0.25
        vol_fn = lambda s, t: jnp.full_like(s, sig)  # noqa: E731
        fn = local_vol.lv_simulate_fn(vol_fn)
        from pde_tpu.models import heston_mc

        price, stderr = heston_mc.price_european_mc(
            None, 100.0, 0.75, S0, jax.random.PRNGKey(2), rate=R, dividend=Q,
            n_steps=48, n_paths=32768, simulate_fn=fn)
        closed = float(bs.price(S0, 100.0, R, Q, 0.75, sig))
        assert abs(float(price) - closed) < 4.0 * float(stderr) + 0.05

    def test_barrier_under_smile_dynamics(self):
        """Exotics price under the Dupire surface through the standard
        estimator stack; knock-out <= vanilla pathwise (same key)."""
        from pde_tpu.models import heston_mc

        Ks = jnp.asarray(np.exp(np.linspace(np.log(60.0), np.log(170.0), 24)))
        Ts = jnp.asarray([0.05, 0.15, 0.3, 0.6])
        surf = local_vol.dupire_surface(HP, Ks, Ts, S0, R, Q)
        fn = local_vol.lv_simulate_fn(
            local_vol.SurfaceInterpolator(Ks, Ts, surf))
        key = jax.random.PRNGKey(4)
        kw = dict(rate=R, dividend=Q, n_steps=32, n_paths=16384)
        b_px, _ = heston_mc.price_barrier_mc(
            None, 100.0, 80.0, 0.5, S0, key, barrier_type="down-and-out",
            simulate_fn=fn, **kw)
        v_px, _ = heston_mc.price_european_mc(
            None, 100.0, 0.5, S0, key, control_variate=False,
            simulate_fn=fn, **kw)
        assert 0.0 < float(b_px) < float(v_px)

    @pytest.mark.slow
    def test_dupire_mc_reprices_heston_vanillas(self):
        """MC under the extracted surface agrees with the generating
        model's CF prices — the round trip again, through a different
        numerical method (log-Euler paths instead of the CN PDE)."""
        from pde_tpu.models import heston_mc

        Ks = jnp.asarray(np.exp(np.linspace(np.log(40.0), np.log(250.0), 50)))
        Ts = jnp.asarray([0.01, 0.03, 0.07, 0.15, 0.3, 0.5, 0.75, 1.0, 1.2])
        surf = local_vol.dupire_surface(HP, Ks, Ts, S0, R, Q)
        fn = local_vol.lv_simulate_fn(
            local_vol.SurfaceInterpolator(Ks, Ts, surf))
        strikes = jnp.asarray([90.0, 100.0, 115.0])
        price, stderr = heston_mc.price_european_mc(
            None, strikes, 1.0, S0, jax.random.PRNGKey(8), rate=R, dividend=Q,
            n_steps=100, n_paths=65536, simulate_fn=fn)
        cf = np.asarray(heston.price_accurate(HP, strikes, 1.0, S0, R, Q))
        err = np.abs(np.asarray(price) - cf)
        tol = 4.0 * np.asarray(stderr) + 0.06  # + O(dt) Euler bias headroom
        assert np.all(err < tol), (np.asarray(price), cf, np.asarray(stderr))


class TestLocalVolPDE:
    def test_constant_vol_matches_black_scholes(self):
        sig = 0.25
        vol_fn = lambda s, t: jnp.full_like(s, sig)  # noqa: E731
        res = local_vol_pde.solve(
            vol_fn, S0, K=100.0, T=1.0, r=R, q=Q, is_call=True,
            n_space=400, n_time=200)
        closed = float(bs.price(S0, 100.0, R, Q, 1.0, sig))
        np.testing.assert_allclose(float(res.price), closed, rtol=2e-4)
        # and agrees with the dedicated constant-vol solver
        ref = bs_pde.solve(bs_pde.BSPDEParams(
            sigma=sig, r=R, q=Q, T=1.0, K=100.0, is_call=True,
            n_space=400, n_time=200), S0)
        np.testing.assert_allclose(float(res.price), float(ref.price),
                                   rtol=5e-5)
        np.testing.assert_allclose(float(res.delta), float(ref.delta),
                                   rtol=1e-3)

    def test_american_put_floors_european(self):
        sig = 0.3
        vol_fn = lambda s, t: jnp.full_like(s, sig)  # noqa: E731
        kw = dict(K=110.0, T=1.0, r=0.06, q=0.0, is_call=False,
                  n_space=300, n_time=150)
        eu = local_vol_pde.solve(vol_fn, S0, american=False, **kw)
        am = local_vol_pde.solve(vol_fn, S0, american=True, **kw)
        assert float(am.price) > float(eu.price)
        assert float(am.price) >= 10.0  # intrinsic
        assert bool(am.early_exercise_optimal)

    def test_fused_march_matches_scan(self):
        """The fused time-varying march kernel (ops/cn1d_tv_fused, interpret
        mode on CPU) must agree with the scan path on a sloped smile surface — single solve
        and a mixed book (strikes x maturities x call/put x Eu/Am) —
        to f32 accumulation tolerance."""
        vol_fn = lambda s, t: (  # noqa: E731
            0.2 + 0.05 * jnp.tanh((s - 100.0) / 20.0) + 0.02 * t)
        kw = dict(r=0.04, q=0.01, n_space=128, n_time=32)
        ref = local_vol_pde.solve(vol_fn, S0, K=100.0, T=1.0,
                                  is_call=True, **kw)
        fus = local_vol_pde.solve_fused(vol_fn, S0, K=100.0, T=1.0,
                                        is_call=True, interpret=True, **kw)
        np.testing.assert_allclose(float(fus.price), float(ref.price),
                                   rtol=3e-5)
        np.testing.assert_allclose(float(fus.delta), float(ref.delta),
                                   rtol=1e-3)

        Ks = jnp.asarray([90.0, 100.0, 110.0, 95.0])
        Ts = jnp.asarray([0.5, 1.0, 1.5, 0.75])
        cs = jnp.asarray([1.0, 0.0, 1.0, 0.0])
        am = jnp.asarray([0.0, 1.0, 0.0, 1.0])
        book = local_vol_pde.solve_fused_batch(
            vol_fn, S0, K=Ks, T=Ts, is_call=cs, american=am,
            interpret=True, **kw)
        for i in range(4):
            one = local_vol_pde.solve(
                vol_fn, S0, K=float(Ks[i]), T=float(Ts[i]),
                is_call=bool(cs[i] > 0.5), american=bool(am[i] > 0.5), **kw)
            np.testing.assert_allclose(
                float(book.price[i]), float(one.price), rtol=3e-5,
                err_msg=f"book lane {i}")

    def test_fused_low_vol_high_rate_book(self):
        """Convection-dominated stress: very low local vol with a large
        |r-q| drift on a coarse grid, where the implicit operator loses
        its M-matrix sign pattern.  The fused route must stay finite and
        agree with the scan route to f32 tolerance."""
        vol_fn = lambda s, t: jnp.full_like(s, 0.03)  # noqa: E731
        kw = dict(r=0.12, q=0.0, n_space=96, n_time=24)
        Ks = jnp.asarray([95.0, 100.0, 105.0, 100.0])
        Ts = jnp.asarray([0.5, 1.0, 1.5, 2.0])
        cs = jnp.asarray([1.0, 0.0, 1.0, 0.0])
        am = jnp.asarray([0.0, 1.0, 0.0, 1.0])
        fus = local_vol_pde.solve_fused_batch(
            vol_fn, S0, K=Ks, T=Ts, is_call=cs, american=am,
            interpret=True, **kw)
        scn = local_vol_pde.solve_batch(
            vol_fn, S0, K=Ks, T=Ts, is_call=cs, american=am, **kw)
        f = np.asarray(fus.price)
        s = np.asarray(scn.price)
        assert np.all(np.isfinite(f)), f
        np.testing.assert_allclose(f, s, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("B", [1, 15, 17, 33])
    def test_fused_book_ragged_batches(self, B):
        """Books that are not a multiple of the kernel's option block are
        padded with copies of option 0 and stripped; every option matches
        the scan route."""
        vol_fn = lambda s, t: (  # noqa: E731
            0.22 + 0.04 * jnp.tanh((100.0 - s) / 25.0))
        kw = dict(r=0.03, q=0.0, n_space=40, n_time=6)
        Ks = jnp.asarray(np.linspace(80.0, 120.0, B))
        Ts = jnp.asarray(np.linspace(0.3, 1.2, B))
        cs = jnp.asarray((np.arange(B) % 2).astype(float))
        am = jnp.asarray((np.arange(B) % 3 == 0).astype(float))
        fus = local_vol_pde.solve_fused_batch(
            vol_fn, S0, K=Ks, T=Ts, is_call=cs, american=am,
            interpret=True, **kw)
        scn = local_vol_pde.solve_batch(
            vol_fn, S0, K=Ks, T=Ts, is_call=cs, american=am, **kw)
        assert fus.price.shape == (B,)
        np.testing.assert_allclose(np.asarray(fus.prices),
                                   np.asarray(scn.prices), rtol=1e-5,
                                   atol=2e-4)

    @pytest.mark.slow
    def test_heston_dupire_roundtrip(self):
        """THE consistency check: the local-vol diffusion built from
        Heston's surface must re-price Heston's vanillas."""
        Ks = jnp.asarray(np.exp(np.linspace(np.log(40.0), np.log(250.0), 60)))
        Ts = jnp.asarray([0.01, 0.02, 0.04, 0.07, 0.12, 0.18, 0.25,
                          0.35, 0.5, 0.65, 0.8, 1.0, 1.2])
        surf = local_vol.dupire_surface(HP, Ks, Ts, S0, R, Q)
        interp = local_vol.SurfaceInterpolator(Ks, Ts, surf)
        for K in (90.0, 100.0, 115.0):
            res = local_vol_pde.solve(
                interp, S0, K=K, T=1.0, r=R, q=Q, is_call=True,
                n_space=500, n_time=250)
            cf = float(heston.price_accurate(HP, K, 1.0, S0, R, Q))
            # measured: 0.03% ITM / 0.08% ATM / 0.28% OTM (the extraction
            # must go through the CONVERGED quadrature — the parity rule's
            # u-truncation bias is ~1e-4 in price but visible after d2/dK2)
            np.testing.assert_allclose(float(res.price), cf, rtol=5e-3)


def test_mxu_band_lattice_matches_pointwise():
    """The one-hot-matmul lattice builder must reproduce the pointwise
    bilinear interpolator to f32 round-off (same clamping), incl. nodes
    beyond the surface's strike range and times beyond its pillars."""
    import math

    from pde_tpu.solvers.local_vol_pde import (
        _band_lattice, _band_lattice_batch_matmul,
    )

    f32 = jnp.float32
    Ks = jnp.asarray(np.linspace(60.0, 150.0, 17), f32)
    Ts = jnp.asarray(np.linspace(0.1, 2.0, 9), f32)
    rng = np.random.default_rng(5)
    grid = jnp.asarray(0.2 + 0.05 * rng.random((9, 17)), f32)
    dupire_interp = local_vol.SurfaceInterpolator(Ks, Ts, grid)
    n, n_time, B = 64, 12, 5
    K = jnp.asarray([70.0, 95.0, 100.0, 120.0, 155.0], f32)
    T = jnp.asarray([0.05, 0.5, 1.0, 1.9, 2.4], f32)  # beyond pillars too
    x = jnp.linspace(math.log(0.2), math.log(5.0), n, dtype=f32)
    dx = float(x[1] - x[0])
    sg = jnp.exp(x)[:, None] * K[None, :]
    mm = _band_lattice_batch_matmul(dupire_interp, sg, dx, T, 0.04, 0.01,
                                    n_time)
    ref = jax.vmap(
        lambda sgb, Tb: _band_lattice(dupire_interp, sgb, dx, Tb,
                                      0.04, 0.01, n_time),
        in_axes=(1, 0), out_axes=2,
    )(sg, T)
    np.testing.assert_allclose(np.asarray(mm), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
