"""Tests for the remaining inventory pieces: multi-strategy manager,
alternative data, storage management, migrations, and the driver entries."""

from datetime import date, datetime, timedelta, timezone

import numpy as np
import pytest

from pde_tpu.backtest.multi_strategy import MultiStrategyManager, get_optimal_strategy
from pde_tpu.data.alternative import (
    AlternativeDataManager,
    SimulatedEventProvider,
    SimulatedMacroProvider,
)
from pde_tpu.data.storage import DataRetentionManager, RetentionPolicy, StorageManager
from pde_tpu.database import TimeSeriesDB
from pde_tpu.database.migrations import MigrationRunner


class TestMultiStrategy:
    def test_vote_blends_families(self):
        mgr = MultiStrategyManager(["X"])
        up = 100 * np.exp(np.linspace(0, 0.3, 120))  # strong uptrend
        score = mgr.vote(up)
        assert score > 0.2

    def test_event_driven_run(self):
        from pde_tpu.backtest import ArrayDataHandler, BacktestEngine, Portfolio
        from pde_tpu.backtest.data_handler import SyntheticDataHandler
        from pde_tpu.backtest.execution import InstantExecutionHandler

        data = SyntheticDataHandler(["X"], n_bars=300, annual_vol=0.35, seed=23)
        engine = BacktestEngine(
            data, MultiStrategyManager(["X"]), Portfolio(), InstantExecutionHandler()
        )
        res = engine.run()
        assert res.n_bars == 300

    def test_optimal_lookup(self):
        assert get_optimal_strategy("UNKNOWN")["strategy"] == "momentum"
        MultiStrategyManager.set_optimization_results(
            {"AAPL": {"strategy": "rsi", "params": {"period": 14}}}
        )
        assert get_optimal_strategy("aapl")["strategy"] == "rsi"


class TestAlternativeData:
    def test_macro_series(self):
        p = SimulatedMacroProvider(seed=1)
        s = p.get_series("DFF", date(2026, 1, 1), date(2026, 4, 1))
        assert len(s.values) == len(s.dates) == 90
        assert 4.0 < s.latest() < 6.5  # near the DFF level

    def test_events_quarterly(self):
        evs = SimulatedEventProvider().get_events("AAPL", date(2026, 1, 1), date(2026, 12, 31))
        assert len(evs) == 4
        assert all(e.event_type.value == "earnings" for e in evs)

    def test_market_context_and_blackout(self):
        mgr = AlternativeDataManager()
        ctx = mgr.market_context(["AAPL", "JPM"], as_of=date(2026, 8, 14))
        assert set(ctx["sentiment"]) == {"AAPL", "JPM"}
        assert -1 <= ctx["sentiment"]["AAPL"] <= 1
        assert ctx["fed_funds"] is not None
        evs = SimulatedEventProvider().get_events("AAPL", date(2026, 1, 1), date(2026, 12, 31))
        assert mgr.earnings_blackout("AAPL", evs[0].event_date)
        assert not mgr.earnings_blackout("AAPL", evs[0].event_date + timedelta(days=30))


class TestStorage:
    @pytest.fixture
    def db(self):
        db = TimeSeriesDB(":memory:")
        rows = [
            {"time": (datetime(2026, 1, 1, tzinfo=timezone.utc) + timedelta(hours=6 * i)).isoformat(),
             "symbol": "SPY", "open": 100.0, "high": 101.0, "low": 99.0,
             "close": 100.0 + 0.1 * i, "volume": 1000.0}
            for i in range(40)  # 10 days x 4 intraday bars
        ]
        db.insert_market_prices(rows)
        return db

    def test_stats(self, db):
        stats = StorageManager(db).stats()
        assert stats.table_rows["market_prices"] == 40
        assert stats.total_bytes > 0
        assert stats.oldest["market_prices"].startswith("2026-01-01")

    def test_daily_aggregate(self, db):
        mgr = StorageManager(db)
        n = mgr.create_daily_aggregate()
        assert n == 10
        con = db._conn()
        row = con.execute(
            "SELECT open, close, volume FROM market_prices_daily WHERE day='2026-01-01'"
        ).fetchone()
        assert row[0] == 100.0  # first bar's open
        assert row[2] == 4000.0  # summed volume

    def test_retention(self, db):
        ret = DataRetentionManager(
            db, [RetentionPolicy("market_prices", keep_days=5)]
        )
        out = ret.enforce(as_of=datetime(2026, 1, 11, tzinfo=timezone.utc))
        assert out["market_prices"] > 0
        remaining = db.query_market_prices("SPY")
        assert all(r["time"] >= "2026-01-06" for r in remaining)

    def test_compact_runs(self, db):
        StorageManager(db).compact()  # must not raise


class TestMigrations:
    def test_upgrade_and_history(self):
        db = TimeSeriesDB(":memory:")
        runner = MigrationRunner(db)
        assert runner.current_version == 1
        applied = runner.upgrade()
        assert applied == [2, 3, 4]
        assert runner.current_version == 4
        assert runner.pending() == []
        # idempotent
        assert runner.upgrade() == []
        names = [h["name"] for h in runner.history()]
        assert names == ["baseline", "add_calibration_runs", "add_fills_table", "add_equity_curve"]
        # new tables usable
        con = db._conn()
        con.execute("INSERT INTO equity_curve VALUES ('2026-01-01T00:00:00', 1e6, 5e5, 4e5)")
        assert con.execute("SELECT COUNT(*) FROM equity_curve").fetchone()[0] == 1


@pytest.mark.slow
class TestGraftEntry:
    def test_entry_jits(self):
        import jax

        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert out.shape == (100,)
        assert bool(np.all(np.isfinite(np.asarray(out))))

    def test_dryrun_multichip_on_virtual_mesh(self, capsys):
        import __graft_entry__ as g

        g.dryrun_multichip(8)
        assert "dryrun_multichip OK" in capsys.readouterr().out


class TestCoverageGaps:
    """Public surfaces found unreferenced by a symbol sweep."""

    def test_sabr_volatility_smile_alias(self):
        import jax.numpy as jnp
        import numpy as np

        from pde_tpu.models import sabr

        p = sabr.SABRParams(alpha=0.25, beta=0.7, rho=-0.3, nu=0.45)
        K = jnp.asarray(np.linspace(80.0, 120.0, 9))
        smile = sabr.volatility_smile(K, 100.0, 1.0, p)
        np.testing.assert_allclose(
            np.asarray(smile),
            np.asarray(sabr.implied_volatilities(K, 100.0, 1.0, p)),
        )

    def test_tridiagonal_solve_dispatcher(self, rng):
        import jax.numpy as jnp
        import numpy as np

        from pde_tpu.ops import tridiag

        # small batch
        B, n = 4, 32
        lower = jnp.asarray(rng.uniform(-1, 1, (B, n - 1)))
        upper = jnp.asarray(rng.uniform(-1, 1, (B, n - 1)))
        diag = jnp.asarray(4 + rng.uniform(0, 1, (B, n)))
        b = jnp.asarray(rng.uniform(-1, 1, (B, n)))
        x = tridiag.tridiagonal_solve(lower, diag, upper, b)
        ref = tridiag.thomas(lower, diag, upper, b)
        np.testing.assert_allclose(np.asarray(x), np.asarray(ref), rtol=1e-10)

        # single long system
        n = 8192
        lower1 = jnp.asarray(rng.uniform(-1, 1, n - 1))
        upper1 = jnp.asarray(rng.uniform(-1, 1, n - 1))
        diag1 = jnp.asarray(4 + rng.uniform(0, 1, n))
        b1 = jnp.asarray(rng.uniform(-1, 1, n))
        x1 = tridiag.tridiagonal_solve(lower1, diag1, upper1, b1)
        ref1 = tridiag.thomas(lower1, diag1, upper1, b1)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(ref1), rtol=1e-8)

    def test_all_dashboard_builders(self, tmp_path):
        from pde_tpu.monitoring import dashboards as d

        built = [
            d.create_trading_dashboard(),
            d.create_risk_dashboard(),
            d.create_system_dashboard(),
            d.create_data_quality_dashboard(),
        ]
        for dash in built:
            assert dash["title"] and dash["panels"], dash.get("title")
        prov = d.DashboardProvisioner(output_dir=tmp_path)
        paths = prov.provision(built)
        assert len(paths) == 4 and all(p.exists() for p in paths)

    def test_alternative_data_providers(self):
        from datetime import date

        from pde_tpu.data import alternative as alt

        macro = alt.SimulatedMacroProvider()
        series = macro.get_series("DGS10", date(2026, 1, 1), date(2026, 3, 1))
        assert len(series.values) > 10 and series.latest() is not None

        sent = alt.SimulatedSentimentProvider()
        score = sent.get_sentiment("SPY")
        assert -1.0 <= score.score <= 1.0

        mgr = alt.AlternativeDataManager(macro=macro, sentiment=sent)
        ctx = mgr.market_context(["SPY"])
        assert ctx["fed_funds"] is not None and "SPY" in ctx["sentiment"]

    def test_historic_dataframe_handler(self):
        import numpy as np
        import pandas as pd

        from pde_tpu.backtest.data_handler import HistoricDataFrameHandler

        idx = pd.date_range("2026-01-01", periods=30, freq="D")
        df = pd.DataFrame({"SPY": np.linspace(100, 110, 30),
                           "QQQ": np.linspace(400, 380, 30)}, index=idx)
        h = HistoricDataFrameHandler(df)
        import queue

        q = queue.Queue()
        n = 0
        while h.continue_backtest:
            h.update_bars(q)
            n += 1
            assert n < 100
        assert not q.empty()
