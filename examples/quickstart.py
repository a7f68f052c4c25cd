"""Library quickstart: fit surfaces, price greeks, stream refits.

Run from the repo root:  python examples/quickstart.py
(works on CPU or GPU; first compiles take seconds each)
"""

import numpy as np
import jax
import jax.numpy as jnp


def main():
    rng = np.random.default_rng(0)

    # ------------------------------------------------------------------
    # 1. Fit a batch of vol surfaces (choose any smile family)
    # ------------------------------------------------------------------
    from iv_engine.surface import eval_surface, fit_eval_surface

    B, E, n = 32, 12, 40                      # surfaces x expiries x strikes
    k = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.05, 1.5, E), (B, E))
    iv = 0.35 + 0.08 * k**2 + 0.01 * jnp.asarray(rng.normal(size=(B, 1, 1)))

    out = fit_eval_surface(k, iv, T, method="cubic_spline", n_grid=50)
    print("surface grid:", out["w_grid"].shape,
          "| butterfly-free:", int(out["butterfly_ok"].sum()), "/", B,
          "| calendar-free:", int(out["calendar_ok"].sum()), "/", B)

    # arbitrary-point queries (total variance, linear in maturity)
    w_q = eval_surface(out["fit"], jnp.zeros((B, 1)), jnp.full((B, 1), 0.7))
    print("w(k=0, T=0.7) sample:", float(w_q[0, 0]))

    # Dupire local vol + risk-neutral density — byproducts of the
    # arbitrage machinery on the evaluated grid
    from iv_engine.surface import local_vol_surface

    lv = local_vol_surface(out)
    print("local vol grid:", lv["local_vol"].shape,
          "| admits real local vol:", int(lv["local_vol_ok"].sum()), "/", B)

    # eSSVI: one global fit per surface — butterfly-free slices and
    # increasing ATM variance guaranteed by construction
    out_e = fit_eval_surface(k, iv, T, method="essvi", n_grid=50,
                             svi_iters=48)
    print("essvi butterfly-free:", int(out_e["butterfly_ok"].sum()), "/", B)

    # ------------------------------------------------------------------
    # 2. Greek surfaces from the fit
    # ------------------------------------------------------------------
    from iv_engine.surface.greeks import greek_surfaces

    g = greek_surfaces(out["k_grid"], out["iv_grid"], out["fit"].expiries,
                       jnp.full((B,), 25_000.0), 0.03, is_call=True)
    print("delta grid:", g["delta"].shape,
          "| atm delta sample:", round(float(g["delta"][0, 0, 25]), 4))

    # ------------------------------------------------------------------
    # 3. SVI / SABR / smoothing-spline smile calibration
    # ------------------------------------------------------------------
    from iv_engine.models.svi import fit_svi_batched, svi_total_variance
    from iv_engine.ops.smoothing_spline import fit_smoothing_spline_autolam

    w_slices = iv**2 * T[..., None]
    svi = fit_svi_batched(k, w_slices, max_iters=60, init="quasi")
    resid = svi_total_variance(svi.params, k) - w_slices
    print("svi max |residual|:", float(jnp.max(jnp.abs(resid))))

    noisy = w_slices[0] + 0.002 * jnp.asarray(rng.normal(size=(E, n)))
    smoothed = fit_smoothing_spline_autolam(
        k[0], noisy, jnp.array([1e-8, 1e-5, 1e-3, 1e-1]))
    print("auto-lam smoothing: max adjustment",
          float(jnp.max(jnp.abs(smoothed.g - noisy))))

    # ------------------------------------------------------------------
    # 4. Streaming: ticks -> candles -> realized vol -> refit, in one jit
    # ------------------------------------------------------------------
    import pandas as pd
    from iv_engine.pipeline.stream_service import StreamingSession

    unds = [f"u{i}" for i in range(8)]
    sess = StreamingSession(unds, k[:8], iv[:8], T[:8],
                            window_minutes=256, n_grid=20)
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)   # 50% annualised vol
    frames = []
    for u in unds:
        minutes = np.sort(rng.integers(0, 256, 1000))
        path = 100 * np.exp(np.cumsum(rng.normal(0, per_min, 256)))
        frames.append(pd.DataFrame({
            "underlying": u, "minute": minutes,
            "price": path[minutes],      # ticks sample the minute path
            "size": rng.uniform(0, 5, 1000)}))
    ticks = pd.concat(frames, ignore_index=True)
    sess.ingest_ticks(ticks)
    refit = sess.refit()
    print("streaming refit:", refit.iv_grid.shape,
          "| realized vol mean:",
          round(float(np.asarray(refit.realized_vol).mean()), 3))

    # ------------------------------------------------------------------
    # 5. Scattered quotes: RBF surface with no-arbitrage penalty repair
    # ------------------------------------------------------------------
    from iv_engine.ops.rbf import eval_rbf, fit_rbf_arbfree

    nq = 512
    kq = jnp.asarray(rng.uniform(-1, 1, nq))
    Tq = jnp.asarray(rng.uniform(0.05, 2.0, nq))
    wq = (0.04 + 0.3 * kq**2) * Tq + 0.01 * jnp.sin(8 * kq) * Tq  # arby
    fit = fit_rbf_arbfree(jnp.stack([kq, Tq], -1), wq, n_iters=24)
    w_at = eval_rbf(fit, jnp.array([[0.0, 1.0]]))
    print("rbf arbfree: butterfly-free:", bool(fit["butterfly_ok"]),
          "| calendar-free:", bool(fit["calendar_ok"]),
          "| w(0, 1y):", round(float(w_at[0]), 4))

    # ------------------------------------------------------------------
    # 6. Andreasen-Huge: arbitrage-free BY CONSTRUCTION (even on
    #    arbitrage-laden quotes, and between quoted maturities)
    # ------------------------------------------------------------------
    from iv_engine.ops.andreasen_huge import (eval_ah,
                                              fit_eval_ah_surface)

    iv_arby = np.asarray(iv[:4, :, :16]).copy()
    iv_arby[:, :, 8] *= 1.4     # butterfly violation at the money
    ah = fit_eval_ah_surface(k[:4, :, :16], jnp.asarray(iv_arby),
                             T[:4], n_grid=129, n_iters=8)
    w_mid = eval_ah(ah["fit"], jnp.zeros((4, 1)), jnp.full((4, 1), 0.5))
    print("andreasen-huge on arby quotes: butterfly-free:",
          int(ah["butterfly_ok"].sum()), "/ 4",
          "| calendar-free:", int(ah["calendar_ok"].sum()), "/ 4",
          "| w(0, 0.5y):", round(float(w_mid[0, 0]), 4))

    # ------------------------------------------------------------------
    # 7. Serving: the same session over Arrow Flight (columnar gRPC)
    # ------------------------------------------------------------------
    from iv_engine.pipeline import flight_service as fs

    if fs.HAVE_FLIGHT:
        import pyarrow.flight as fl
        srv = fs.FlightStreamServer(sess, port=0)
        client = fl.connect(f"grpc+tcp://127.0.0.1:{srv.port}")
        tbl = client.do_get(fl.Ticket(b"refit")).read_all()
        print("flight refit table:", tbl.num_rows, "underlyings,",
              "cols:", tbl.column_names)
        client.close()
        srv.shutdown()
    else:
        print("pyarrow.flight unavailable — JSONL server only "
              "(pipeline/serve.py)")


if __name__ == "__main__":
    main()
