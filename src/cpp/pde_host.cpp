// pde_host: native host-side runtime engine for pde_tpu.
//
// The accelerator (JAX/XLA/Pallas) owns the device compute path; this library owns
// the latency-critical HOST paths, the role C++ plays in the reference
// platform (src/cpp in dharvpat/PDE): stream processing, the backtest inner
// loop, and float64 numerical oracles used by the test-suite to cross-check
// the JAX implementations.
//
// Plain C ABI (loaded via ctypes — no pybind11 dependency in this image).
// Build: see pde_tpu/native/loader.py (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tick -> OHLCV bar aggregation.
//
// times (seconds), prices, sizes: n ticks, times non-decreasing.
// Emits one row [start_time, open, high, low, close, volume] per time bucket
// of width bar_seconds into out (capacity max_bars rows). Returns bars written.
int64_t aggregate_bars(const double* times, const double* prices, const double* sizes,
                       int64_t n, double bar_seconds, double* out, int64_t max_bars) {
    if (n <= 0 || bar_seconds <= 0.0 || max_bars <= 0) return 0;

    int64_t n_bars = 0;
    int64_t bucket = (int64_t)std::floor(times[0] / bar_seconds);
    double o = prices[0], h = prices[0], l = prices[0], c = prices[0], v = sizes[0];
    double start = bucket * bar_seconds;

    for (int64_t i = 1; i < n; ++i) {
        int64_t b = (int64_t)std::floor(times[i] / bar_seconds);
        if (b != bucket) {
            if (n_bars < max_bars) {
                double* row = out + 6 * n_bars;
                row[0] = start; row[1] = o; row[2] = h; row[3] = l; row[4] = c; row[5] = v;
            }
            ++n_bars;
            bucket = b;
            start = b * bar_seconds;
            o = h = l = c = prices[i];
            v = sizes[i];
        } else {
            h = std::max(h, prices[i]);
            l = std::min(l, prices[i]);
            c = prices[i];
            v += sizes[i];
        }
    }
    if (n_bars < max_bars) {
        double* row = out + 6 * n_bars;
        row[0] = start; row[1] = o; row[2] = h; row[3] = l; row[4] = c; row[5] = v;
    }
    ++n_bars;
    return std::min(n_bars, max_bars);
}

// ---------------------------------------------------------------------------
// Vectorized position backtest (the host fast path of
// pde_tpu.backtest.vectorized.equity_from_positions):
//   r_t = pos_{t-1} * (p_t/p_{t-1} - 1) - cost * |pos_t - pos_{t-1}|
// out_returns: n-1, out_equity: n (equity[0] = 1).
// out_stats: [total_return, annualized_sharpe, max_drawdown, n_flips]
void run_position_backtest(const double* prices, const double* positions, int64_t n,
                           double cost_per_turnover, double* out_returns,
                           double* out_equity, double* out_stats) {
    if (n < 2) return;
    out_equity[0] = 1.0;
    double prev_pos = 0.0;
    double sum = 0.0, sum2 = 0.0;
    double peak = 1.0, max_dd = 0.0;
    int64_t flips = 0;

    for (int64_t t = 0; t < n - 1; ++t) {
        double turnover = std::fabs(positions[t] - prev_pos);
        if (turnover > 0.0) ++flips;
        double asset_ret = prices[t + 1] / prices[t] - 1.0;
        double r = positions[t] * asset_ret - cost_per_turnover * turnover;
        out_returns[t] = r;
        out_equity[t + 1] = out_equity[t] * (1.0 + r);
        prev_pos = positions[t];

        sum += r;
        sum2 += r * r;
        peak = std::max(peak, out_equity[t + 1]);
        max_dd = std::max(max_dd, 1.0 - out_equity[t + 1] / peak);
    }
    int64_t m = n - 1;
    double mean = sum / m;
    double var = sum2 / m - mean * mean;
    double sd = var > 0.0 ? std::sqrt(var) : 0.0;
    out_stats[0] = out_equity[n - 1] - 1.0;
    out_stats[1] = sd > 0.0 ? mean / sd * std::sqrt(252.0) : 0.0;
    out_stats[2] = max_dd;
    out_stats[3] = (double)flips;
}

// ---------------------------------------------------------------------------
// Batched tridiagonal (Thomas) solve: float64 oracle for the Pallas/scan
// kernels. Layout: batch-major — lower[b*(n-1)+i], diag[b*n+i], etc.
void thomas_solve(const double* lower, const double* diag, const double* upper,
                  const double* rhs, int64_t n, int64_t batch, double* out,
                  double* work /* 2*n scratch */) {
    double* cp = work;
    double* dp = work + n;
    for (int64_t b = 0; b < batch; ++b) {
        const double* lo = lower + b * (n - 1);
        const double* d = diag + b * n;
        const double* up = upper + b * (n - 1);
        const double* r = rhs + b * n;
        double* x = out + b * n;

        cp[0] = up[0] / d[0];
        dp[0] = r[0] / d[0];
        for (int64_t i = 1; i < n; ++i) {
            double m = d[i] - lo[i - 1] * cp[i - 1];
            cp[i] = (i < n - 1) ? up[i] / m : 0.0;
            dp[i] = (r[i] - lo[i - 1] * dp[i - 1]) / m;
        }
        x[n - 1] = dp[n - 1];
        for (int64_t i = n - 2; i >= 0; --i) {
            x[i] = dp[i] - cp[i] * x[i + 1];
        }
    }
}

// ---------------------------------------------------------------------------
// Closed-form OU AR(1) MLE: float64 oracle mirroring pde_tpu.models.ou.fit_mle.
// out: [theta, mu, sigma]
void ou_mle(const double* x, int64_t n_points, double dt, double* out) {
    int64_t n = n_points - 1;
    if (n < 2) { out[0] = out[1] = out[2] = 0.0; return; }
    double sx = 0, sy = 0, sxx = 0, syy = 0, sxy = 0;
    for (int64_t i = 0; i < n; ++i) {
        double a = x[i], b = x[i + 1];
        sx += a; sy += b; sxx += a * a; syy += b * b; sxy += a * b;
    }
    double mean_x = sx / n, mean_y = sy / n;
    double var_x = sxx / n - mean_x * mean_x;
    double var_y = syy / n - mean_y * mean_y;
    double cov = sxy / n - mean_x * mean_y;

    if (var_x < 1e-12) { out[0] = mean_x; out[1] = 0.0; out[2] = 0.0; return; }
    double bhat = cov / var_x;
    if (bhat >= 1.0) bhat = 0.9999;
    if (bhat <= 0.0) bhat = 0.0001;
    double mu = -std::log(bhat) / dt;
    double a_hat = mean_y - bhat * mean_x;
    double theta = (std::fabs(1.0 - bhat) > 1e-12) ? a_hat / (1.0 - bhat)
                                                   : 0.5 * (mean_x + mean_y);
    double resid_var = std::max(var_y - bhat * bhat * var_x, 1e-12);
    double ef = 1.0 - std::exp(-2.0 * mu * dt);
    double sigma = (mu > 1e-12 && ef > 1e-12) ? std::sqrt(2.0 * mu * resid_var / ef)
                                              : std::sqrt(resid_var / dt);
    out[0] = theta; out[1] = mu; out[2] = sigma;
}

// ---------------------------------------------------------------------------
// Rolling z-score mean-reversion position walk (the event-driven strategy's
// native twin; used to accelerate long-history signal generation).
void zscore_positions(const double* prices, int64_t n, int64_t lookback,
                      double entry_z, double exit_z, double* out) {
    double state = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        if (i < lookback - 1) { out[i] = 0.0; continue; }
        double s = 0.0, s2 = 0.0;
        for (int64_t j = i - lookback + 1; j <= i; ++j) { s += prices[j]; s2 += prices[j] * prices[j]; }
        double mean = s / lookback;
        double var = (s2 - lookback * mean * mean) / (lookback - 1);
        double z = var > 0.0 ? (prices[i] - mean) / std::sqrt(var) : 0.0;
        if (state == 0.0) {
            if (z < -entry_z) state = 1.0;
            else if (z > entry_z) state = -1.0;
        } else if (state == 1.0 && z >= -exit_z) {
            state = 0.0;
        } else if (state == -1.0 && z <= exit_z) {
            state = 0.0;
        }
        out[i] = state;
    }
}

// ---------------------------------------------------------------------------
// Heston Carr-Madan pricing: float64 oracle of models.heston.price_carr_madan
// (independent implementation of the Heston 1993 CF in the stable branch-cut
// formulation + the damped Carr-Madan integral; same quadrature convention
// as the reference engine: j = 1..n_points-1 unit weights, alpha damping).
// is_call: 1.0 call / 0.0 put (parity).  out: n prices.
void heston_price_batch(double kappa, double theta, double sigma, double rho,
                        double v0, double spot, double r, double q,
                        const double* strikes, const double* maturities,
                        const double* is_call, int64_t n,
                        int64_t n_points, double du, double alpha,
                        double* out) {
    using cplx = std::complex<double>;
    const cplx I(0.0, 1.0);
    const double sigma2 = sigma * sigma;

    for (int64_t k = 0; k < n; ++k) {
        const double K = strikes[k];
        const double T = maturities[k];
        if (T <= 0.0) {
            double intr = is_call[k] > 0.5 ? std::max(spot - K, 0.0)
                                           : std::max(K - spot, 0.0);
            out[k] = intr;
            continue;
        }
        const double log_fk = std::log(spot / K) + (r - q) * T;
        double sum = 0.0;
        for (int64_t j = 1; j < n_points; ++j) {
            const double v = j * du;
            const cplx u = cplx(v, -(alpha + 1.0));
            // reduced CF exp(C + D v0) (phase terms folded into log_fk)
            const cplx xi = kappa - rho * sigma * I * u;
            const cplx d = std::sqrt(xi * xi + sigma2 * (I * u + u * u));
            const cplx g = (xi - d) / (xi + d);
            const cplx emdT = std::exp(-d * T);
            const cplx C = (kappa * theta / sigma2) *
                ((xi - d) * T - 2.0 * std::log((1.0 - g * emdT) / (1.0 - g)));
            const cplx D = ((xi - d) / sigma2) * ((1.0 - emdT) / (1.0 - g * emdT));
            const cplx cf = std::exp(C + D * v0 + I * v * log_fk);
            const cplx denom(alpha * alpha + alpha - v * v, (2.0 * alpha + 1.0) * v);
            sum += (cf / denom).real();
        }
        const double discount = std::exp(-r * T);
        const double fwd_over_k = std::exp(log_fk);
        const double prefactor = K * std::pow(fwd_over_k, alpha + 1.0);
        double call = std::max(prefactor / M_PI * discount * du * sum, 0.0);
        if (is_call[k] > 0.5) {
            out[k] = call;
        } else {
            out[k] = std::max(call - spot * std::exp(-q * T) + K * discount, 0.0);
        }
    }
}

// ---------------------------------------------------------------------------
// SABR Hagan (2002) lognormal implied vol: float64 oracle of
// models.sabr.implied_volatility (same branch structure: zero-maturity
// shortcut, ATM cutoff 1e-6, small-z Taylor of chi).
void sabr_vols(double alpha, double beta, double rho, double nu,
               double forward, double maturity,
               const double* strikes, int64_t n, double* out) {
    const double EPS = 1e-10, ATM = 1e-6;
    const double omb = 1.0 - beta;
    for (int64_t k = 0; k < n; ++k) {
        const double K = strikes[k];
        const double log_fk = std::log(forward / K);
        const double fk_mid = std::sqrt(forward * K);
        const double fk_pow = std::pow(fk_mid, omb);
        if (maturity < EPS) { out[k] = alpha / fk_pow; continue; }

        const double f_pow = std::pow(forward, omb);
        const double t1a = (omb * omb / 24.0) * alpha * alpha / (f_pow * f_pow);
        const double t2a = (rho * beta * nu * alpha) / (4.0 * f_pow);
        const double t3 = ((2.0 - 3.0 * rho * rho) / 24.0) * nu * nu;
        const double atm_vol = alpha / f_pow * (1.0 + (t1a + t2a + t3) * maturity);
        if (std::fabs(log_fk) < ATM) { out[k] = atm_vol; continue; }

        double z_over_chi = 1.0;
        if (nu >= EPS && alpha >= EPS) {
            const double z = (nu / std::max(alpha, EPS)) * fk_pow * log_fk;
            if (std::fabs(z) >= EPS) {
                double chi;
                if (std::fabs(z) < EPS) {
                    chi = z * (1.0 + 0.5 * rho * z + (2.0 * rho * rho - 1.0) / 6.0 * z * z);
                } else {
                    const double sq = std::sqrt(std::max(1.0 - 2.0 * rho * z + z * z, 0.0));
                    const double numer = std::max(sq + z - rho, EPS);
                    double denom = 1.0 - rho;
                    if (std::fabs(denom) < EPS) denom = EPS;
                    chi = std::log(numer / denom);
                }
                z_over_chi = z / chi;
            }
        }
        const double lfk2 = log_fk * log_fk;
        const double series = 1.0 + (omb * omb / 24.0) * lfk2
                              + (std::pow(omb, 4) / 1920.0) * lfk2 * lfk2;
        const double t1 = (omb * omb / 24.0) * alpha * alpha / (fk_pow * fk_pow);
        const double t2 = (rho * beta * nu * alpha) / (4.0 * fk_pow);
        const double corr = 1.0 + (t1 + t2 + t3) * maturity;
        out[k] = (alpha / (fk_pow * series)) * z_over_chi * corr;
    }
}

// ---------------------------------------------------------------------------
// Order-stream fill engine: native twin of
// pde_tpu.backtest.execution.SimulatedExecutionHandler (itself mirroring the
// reference execution.py:249-480).  Processes a whole order stream against a
// tick path in one call - market/limit/stop triggering, slippage + square-
// root market impact, IBKR-style commission (0.005/share, min 1, cap 1% of
// value).  Orders rest until marketable; unfilled orders get NaN outputs.
//
// Resting orders live in four price-indexed books (limit-buy / limit-sell /
// stop-buy / stop-sell), so each order is inserted and popped exactly once:
// O(n_ticks + n_orders log n_orders) total, NOT O(n_ticks * n_resting).
//
// sides: +1 buy / -1 sell.  types: 0 market, 1 limit, 2 stop.
// out: n_orders rows of [fill_time, fill_price, commission, slippage].
// Returns the number of filled orders.
int64_t simulate_fills(const double* tick_times, const double* tick_prices,
                       int64_t n_ticks,
                       const double* submit_times, const double* sides,
                       const double* types, const double* limit_prices,
                       const double* stop_prices, const double* quantities,
                       int64_t n_orders,
                       double slippage_pct, double impact_coeff, double adv,
                       double* out) {
    const double NaN = std::nan("");
    for (int64_t k = 0; k < n_orders; ++k) {
        double* row = out + 4 * k;
        row[0] = row[1] = row[2] = row[3] = NaN;
    }

    int64_t next_order = 0;  // orders sorted by submit time
    int64_t n_filled = 0;

    // trigger-price books; multimap preserves FIFO within a price level
    std::multimap<double, int64_t, std::greater<double>> limit_buys;  // fill when px <= limit (highest first)
    std::multimap<double, int64_t> limit_sells;                       // fill when px >= limit (lowest first)
    std::multimap<double, int64_t> stop_buys;                         // fill when px >= stop (lowest first)
    std::multimap<double, int64_t, std::greater<double>> stop_sells;  // fill when px <= stop (highest first)

    auto fill_order = [&](int64_t k, double now, double price) {
        const double q = std::fabs(quantities[k]);
        const double impact = impact_coeff * std::sqrt(q / adv);
        double fp = price * (1.0 + sides[k] * (slippage_pct + impact));
        if ((int)types[k] == 1) {
            // a limit order never fills through its limit: slippage/impact
            // is capped at the limit price (the maker's protection)
            fp = sides[k] > 0.0 ? std::min(fp, limit_prices[k])
                                : std::max(fp, limit_prices[k]);
        }
        const double raw = q * 0.005;
        const double cap = 0.01 * q * fp;
        double* row = out + 4 * k;
        row[0] = now;
        row[1] = fp;
        row[2] = std::min(std::max(raw, 1.0), cap);
        row[3] = std::fabs(fp - price) * q;
        ++n_filled;
    };

    for (int64_t t = 0; t < n_ticks; ++t) {
        const double now = tick_times[t];
        const double price = tick_prices[t];

        while (next_order < n_orders && submit_times[next_order] <= now) {
            const int64_t k = next_order++;
            const int type = (int)types[k];
            if (type == 0) {
                if (price > 0.0) {
                    fill_order(k, now, price);
                } else if (sides[k] > 0.0) {
                    // no valid market yet: park the market order as an
                    // always-marketable book entry so it fills at the first
                    // real price.  (The Python event handler DROPS orders
                    // that arrive before any market data — deliberate
                    // difference; resting is the safer semantic.)
                    limit_buys.emplace(std::numeric_limits<double>::infinity(), k);
                } else {
                    limit_sells.emplace(-std::numeric_limits<double>::infinity(), k);
                }
            } else if (type == 1) {
                if (sides[k] > 0.0) limit_buys.emplace(limit_prices[k], k);
                else limit_sells.emplace(limit_prices[k], k);
            } else {
                if (sides[k] > 0.0) stop_buys.emplace(stop_prices[k], k);
                else stop_sells.emplace(stop_prices[k], k);
            }
        }
        if (price <= 0.0) continue;

        // pop every book entry whose trigger crosses the current price
        while (!limit_buys.empty() && price <= limit_buys.begin()->first) {
            fill_order(limit_buys.begin()->second, now, price);
            limit_buys.erase(limit_buys.begin());
        }
        while (!limit_sells.empty() && price >= limit_sells.begin()->first) {
            fill_order(limit_sells.begin()->second, now, price);
            limit_sells.erase(limit_sells.begin());
        }
        while (!stop_buys.empty() && price >= stop_buys.begin()->first) {
            fill_order(stop_buys.begin()->second, now, price);
            stop_buys.erase(stop_buys.begin());
        }
        while (!stop_sells.empty() && price <= stop_sells.begin()->first) {
            fill_order(stop_sells.begin()->second, now, price);
            stop_sells.erase(stop_sells.begin());
        }
    }
    return n_filled;
}

// ---------------------------------------------------------------------------
// Black-Scholes implied volatility: float64 oracle of
// pde_tpu.models.black_scholes.implied_vol (same scheme as the reference
// HestonModel::implied_volatility, heston.cpp:311-349: Newton from vol0 with
// the vega guard, clipped into [0.001, 5], |diff| < tol stop).
// is_call: 1/0.  vol0 <= 0 uses the Brenner-Subrahmanyam initial guess.
void bs_implied_vol(const double* target, const double* spot, const double* strike,
                    double r, double q, const double* maturity,
                    const double* is_call, int64_t n, double vol0,
                    int64_t max_iter, double tol, double* out) {
    const double SQRT2PI = std::sqrt(2.0 * M_PI);
    for (int64_t k = 0; k < n; ++k) {
        const double S = spot[k], K = strike[k], T = maturity[k], y = target[k];
        if (T <= 0.0) { out[k] = 0.0; continue; }
        double vol = vol0 > 0.0 ? vol0
                                : std::sqrt(2.0 * M_PI / T) * y / std::max(S, 1e-12);
        vol = std::min(std::max(vol, 0.001), 5.0);
        for (int64_t it = 0; it < max_iter; ++it) {
            const double sq = vol * std::sqrt(T);
            const double d1 = (std::log(S / K) + (r - q + 0.5 * vol * vol) * T) / sq;
            const double d2 = d1 - sq;
            const double nd1 = 0.5 * std::erfc(-d1 / std::sqrt(2.0));
            const double nd2 = 0.5 * std::erfc(-d2 / std::sqrt(2.0));
            const double df_q = std::exp(-q * T), df_r = std::exp(-r * T);
            double price = is_call[k] > 0.5
                ? S * df_q * nd1 - K * df_r * nd2
                : K * df_r * (1.0 - nd2) - S * df_q * (1.0 - nd1);
            const double diff = price - y;
            if (std::fabs(diff) < tol) break;
            const double vega =
                S * df_q * std::sqrt(T) * std::exp(-0.5 * d1 * d1) / SQRT2PI;
            if (vega < 1e-12) { vol = std::min(vol * 1.5, 5.0); continue; }
            // damped Newton: a barely-nonzero vega makes the raw step
            // explode (observed 0.005 <-> 5.0 oscillation on deep-OTM
            // puts); cap each move at 2x so the iterate homes in
            // geometrically, preserving quadratic convergence near the root
            double next = vol - diff / vega;
            next = std::min(std::max(next, 0.5 * vol), 2.0 * vol);
            vol = std::min(std::max(next, 0.001), 5.0);
        }
        out[k] = vol;
    }
}

int32_t pde_host_abi_version() { return 3; }

}  // extern "C"
