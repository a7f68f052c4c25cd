"""Smoke run of the engine's main paths on one GPU, checked against plain
references. The quickest proof that the system still starts on the card.

    python chip_smoke.py          # device, pipeline, surface, stream and
                                  # the gpu-marked tests
    python chip_smoke.py --four   # sharded pipeline + surfaces on 4 GPUs
                                  # vs the same run pinned to one device

Everything runs in this one process: no phase starts a child that touches
JAX. Each phase prints one JSON line with its numbers, its oracle errors
and ``peak_bytes_in_use``; any failed check raises, and the script exits
non-zero. It refuses to run unless JAX's first device is a GPU. The last
line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

The phase functions take their sizes as arguments so the CPU test suite
can drive each one at a tiny size (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SYMBOLS = 2000                      # x 24 h: README's full pipeline run
N_CHECK = 20                          # symbols compared with the oracles
SURF_B, SURF_E, SURF_N = 32768, 30, 50
STREAM_B, STREAM_L, STREAM_MIN, STREAM_BAR = 1024, 4096, 512, 5
F32_SPLINE_TOL = 1e-6                 # f32 ulp at w~1.6 is 1.2e-7
PARITY_TOL = 1e-8                     # compensated path vs SciPy x64


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields,
                      "peak_bytes_in_use": peak_bytes()}, default=float),
          flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()


def cli(*argv) -> list:
    """Run the CLI in this process; return the JSON objects it printed."""
    from iv_engine import cli as _cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _cli.main(list(argv) + ["--json"])
    check(rc == 0, f"cli {' '.join(argv)} exited {rc}: {buf.getvalue()}")
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


@contextlib.contextmanager
def in_dir(path, **env):
    """chdir (the CLI keeps runs/ and logs/ under the working directory)
    and set ``IVTPU_*`` overrides for the duration."""
    old_cwd, old_env = os.getcwd(), {k: os.environ.get(k) for k in env}
    os.chdir(path)
    os.environ.update(env)
    try:
        yield
    finally:
        os.chdir(old_cwd)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# plain references


def reference_interpolation(sd):
    """The reference Task-1 algorithm (core.py:16-81, is_interpolated
    fixed) on one symbol's hourly rows: pandas linear interpolation."""
    import pandas as pd
    sd = sd.sort_values("date").reset_index(drop=True)
    timeline = pd.date_range(sd["date"].min(), sd["date"].max(), freq="1min")
    merged = pd.DataFrame({"date": timeline}).merge(sd, on="date", how="left")
    was_obs = merged["symbol"].notna()
    for col in ("iv", "underlying_price", "time_to_maturity"):
        merged[col] = merged[col].interpolate(method="linear")
    for col in ("symbol", "mark_price", "index_price", "volume"):
        merged[col] = merged[col].ffill()
    merged["is_interpolated"] = ~was_obs
    return merged


def reference_candles(minute_df, freq="5min", min_count=5):
    """The reference Task-2 pandas groupby (core.py:70-89)."""
    data = minute_df.sort_values("timestamp").copy()
    data["g"] = data["timestamp"].dt.floor(freq)
    agg = data.groupby("g").agg(
        open=("open", "first"), high=("high", "max"), low=("low", "min"),
        close=("close", "last"), volume=("volume", "sum"))
    return agg[data.groupby("g").size() >= min_count]


def reference_tick_candles(minute, price, size, n_minutes, bucket):
    """NumPy f64 OHLCV of time-sorted ticks: 1-minute bars, then
    ``bucket``-minute bars from complete runs of 1-minute bars."""
    B = minute.shape[0]
    one = {k: np.full((B, n_minutes), np.nan) for k in
           ("open", "high", "low", "close")}
    one["volume"] = np.zeros((B, n_minutes))
    one["count"] = np.zeros((B, n_minutes), np.int64)
    for b in range(B):
        m = minute[b]
        starts = np.flatnonzero(np.r_[True, m[1:] != m[:-1]])
        ends = np.r_[starts[1:], len(m)]
        mins = m[starts]
        p = price[b].astype(np.float64)
        one["open"][b, mins] = p[starts]
        one["close"][b, mins] = p[ends - 1]
        one["high"][b, mins] = np.maximum.reduceat(p, starts)
        one["low"][b, mins] = np.minimum.reduceat(p, starts)
        one["volume"][b, mins] = np.add.reduceat(
            size[b].astype(np.float64), starts)
        one["count"][b, mins] = ends - starts
    n5 = n_minutes // bucket + 1
    pad = n5 * bucket - n_minutes
    ok = np.pad(one["count"] > 0, ((0, 0), (0, pad)))
    grid = lambda a, fill: np.pad(a, ((0, 0), (0, pad)),
                                  constant_values=fill).reshape(B, n5, bucket)
    okg = ok.reshape(B, n5, bucket)
    idx = np.arange(bucket)
    first = np.where(okg, idx, bucket).min(-1)
    last = np.where(okg, idx, -1).max(-1)
    take = lambda a, i: np.take_along_axis(
        grid(a, np.nan), np.clip(i, 0, bucket - 1)[..., None], -1)[..., 0]
    five = {
        "open": take(one["open"], first),
        "close": take(one["close"], last),
        "high": np.where(okg, grid(one["high"], np.nan), -np.inf).max(-1),
        "low": np.where(okg, grid(one["low"], np.nan), np.inf).min(-1),
        "volume": grid(one["volume"], 0.0).sum(-1),
        "count": okg.sum(-1),
    }
    return one, five


# ---------------------------------------------------------------------------
# phases


def phase_device() -> dict:
    import jax
    line = card_line()
    print(line, flush=True)
    devs = jax.devices()
    out = {"card": line, "jax": jax.__version__,
           "devices": [str(d) for d in devs]}
    emit("device", **out)
    return out


def _tables(root):
    from iv_engine.pipeline import storage as st
    store = st.ParquetStore(root)
    return {t: store.read(t) for t in
            (st.TICKERS, st.INTERPOLATED, st.MINUTE_CANDLES,
             st.RECONSTRUCTED)}


def run_pipeline(workdir, n_symbols, **env) -> dict:
    """CLI: generate 24 h of sample tickers, fused pipeline, audit."""
    root = os.path.join(workdir, "data")
    os.makedirs(root, exist_ok=True)
    with in_dir(workdir, **env):
        cli("--generate-sample-tickers", "--symbols", str(n_symbols),
            "--data-root", root)
        t0 = time.perf_counter()
        res = cli("--task", "pipeline", "--data-root", root, "--yes")[-1]
        wall = time.perf_counter() - t0
        audit = cli("--check", "--data-root", root)
    return {"root": root, "result": res, "wall_s": wall, "audit": audit}


def phase_pipeline(workdir, n_symbols=N_SYMBOLS, n_check=N_CHECK) -> dict:
    """Hourly IV -> 1-min -> synthetic OHLCV -> 5-min, through the CLI,
    with n_check symbols' three tables compared with the oracles."""
    import pandas as pd
    from iv_engine.pipeline import storage as st

    run = run_pipeline(workdir, n_symbols)
    res = run["result"]
    for task in ("task1", "bridge", "task2"):
        done = res[task]["by_status"].get("completed", 0)
        check(done == n_symbols, f"{task}: {done}/{n_symbols} completed")
    check(all(a.get("ok", True) for a in run["audit"][1:3]),
          f"--check audit failed: {run['audit'][1:3]}")
    tabs = _tables(run["root"])
    syms = sorted(tabs[st.TICKERS]["symbol"].unique())
    pick = [syms[i] for i in np.linspace(0, len(syms) - 1, n_check,
                                         dtype=int)]
    err = {"interp_rel": 0.0, "candles_rel": 0.0}
    for sym in pick:
        src = tabs[st.TICKERS][tabs[st.TICKERS]["symbol"] == sym]
        ref = reference_interpolation(src)
        got = tabs[st.INTERPOLATED][tabs[st.INTERPOLATED]["symbol"] == sym
                                    ].sort_values("date")
        check(len(got) == len(ref), f"{sym}: {len(got)} rows vs {len(ref)}")
        check((got["date"].to_numpy() == ref["date"].to_numpy()).all(),
              f"{sym}: interpolated timeline differs")
        check((got["is_interpolated"].to_numpy()
               == ref["is_interpolated"].to_numpy()).all(),
              f"{sym}: is_interpolated differs")
        for col in ("iv", "underlying_price", "time_to_maturity",
                    "mark_price", "index_price", "volume"):
            a = got[col].to_numpy(float)
            b = ref[col].to_numpy(float)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
            err["interp_rel"] = max(err["interp_rel"], float(rel.max()))
            check(np.allclose(a, b, rtol=1e-6, atol=1e-6),
                  f"{sym}:{col} max rel err {rel.max():.3g}")
        # bridge: the reference draws per row from a global RNG, so the
        # oracle is its row set and OHLC invariants (test_pipeline.py)
        mc = tabs[st.MINUTE_CANDLES][tabs[st.MINUTE_CANDLES]["symbol"] == sym
                                     ].sort_values("timestamp")
        check((mc["timestamp"].to_numpy() == ref["date"].to_numpy()).all(),
              f"{sym}: minute candles do not cover the interpolated rows")
        o, h, l, c, v = (mc[k].to_numpy(float) for k in
                         ("open", "high", "low", "close", "volume"))
        check(np.isfinite([o, h, l, c, v]).all(), f"{sym}: non-finite OHLCV")
        check(((h >= np.maximum(o, c)) & (l <= np.minimum(o, c))
               & (v >= 0)).all(), f"{sym}: OHLC invariants broken")
        oracle = reference_candles(mc)
        rc = tabs[st.RECONSTRUCTED]
        rc = rc[rc["symbol"] == sym].sort_values("timestamp")
        check(len(rc) == len(oracle), f"{sym}: {len(rc)} 5-min rows vs "
              f"{len(oracle)}")
        check((rc["timestamp"].to_numpy() == oracle.index.to_numpy()).all(),
              f"{sym}: 5-min timestamps differ")
        for col in ("open", "high", "low", "close"):
            a, b = rc[col].to_numpy(float), oracle[col].to_numpy(float)
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
            err["candles_rel"] = max(err["candles_rel"], float(rel.max()))
            check(np.allclose(a, b, rtol=1e-6, atol=0),
                  f"{sym}:5min {col} max rel err {rel.max():.3g}")
        # volume is an f32 prefix-sum difference: the aggregation tests'
        # f64-oracle bound is 4e-7 * window total + 1e-5
        verr = np.abs(rc["volume"].to_numpy(float)
                      - oracle["volume"].to_numpy(float))
        bound = 4e-7 * np.abs(v).sum() + 1e-5
        err["volume_abs"] = max(err.get("volume_abs", 0.0),
                                float(verr.max()))
        check((verr <= bound).all(),
              f"{sym}:5min volume err {verr.max():.3g} > {bound:.3g}")
    rows = {t: len(df) for t, df in tabs.items() if t != st.TICKERS}
    out = {"symbols": n_symbols, "rows_in": len(tabs[st.TICKERS]),
           "rows_written": rows, "rows_written_total": sum(rows.values()),
           "wall_s": run["wall_s"], "checked_symbols": len(pick),
           "max_rel_err": err}
    emit("pipeline", **out)
    out["root"] = run["root"]
    return out


def _surface_summary(root, method):
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.surface_task import SURFACES
    store = st.ParquetStore(root)
    store.drop(SURFACES)
    res = cli("--task", "surface", "--method", method,
              "--data-root", root)[-1]["surface"]
    df = store.read(SURFACES)
    return res, df


def phase_surface(root, workdir, methods=None, B=SURF_B, E=SURF_E,
                  N=SURF_N, n_oracle=64) -> dict:
    """Every registered family through the CLI on the pipeline's store,
    then the cubic-spline headline and the parity path at full width."""
    from iv_engine import models
    fams = {}
    with in_dir(workdir):
        for m in (methods or models.available()):
            t0 = time.perf_counter()
            res, df = _surface_summary(root, m)
            check(res["surfaces"] > 0, f"{m}: no surface fitted")
            n = res["surfaces"]
            grid = df[["total_variance", "iv"]].to_numpy(float)
            rmse = (df.groupby("underlying")["fit_rmse"].first().to_numpy()
                    if "fit_rmse" in df else np.zeros(1))
            check(np.isfinite(grid).all(), f"{m}: non-finite surface grid")
            check(np.isfinite(rmse).all(), f"{m}: non-finite fit rmse")
            fams[m] = {"surfaces": res["surfaces"],
                       "butterfly_frac": res["butterfly_ok"] / n,
                       "calendar_frac": res["calendar_ok"] / n,
                       "fit_rmse_max": float(rmse.max()),
                       "wall_s": time.perf_counter() - t0}
    out = {"families": fams, **headline_spline(B, E, N, n_oracle),
           **parity_spline(B, E, N, n_oracle)}
    emit("surface", **out)
    return out


def _smiles(B, E, N, seed):
    """Clean convex smiles iv = atm + curv k^2 (bench.py's population)."""
    rng = np.random.default_rng(seed)
    k_row = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    atm = rng.uniform(0.15, 0.6, (B, 1, 1))
    curv = rng.uniform(0.05, 0.3, (B, 1, 1))
    iv = np.broadcast_to(atm + curv * k_row * k_row, (B, E, N))
    T = np.linspace(0.05, 2.0, E, dtype=np.float32)
    return k_row, iv.astype(np.float32), T


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def _oracle_err(w, iv, k_row, T, q, n_oracle):
    """max |w - SciPy x64 not-a-knot CubicSpline(w = iv^2 T)(q)| over the
    first n_oracle surfaces, every expiry."""
    from scipy.interpolate import CubicSpline
    err = 0.0
    for b in range(min(n_oracle, w.shape[0])):
        for e in range(w.shape[1]):
            knots = iv[b, e].astype(np.float64) ** 2 * float(T[e])
            ref = CubicSpline(k_row.astype(np.float64), knots,
                              bc_type="not-a-knot")(q)
            err = max(err, float(np.abs(w[b, e] - ref).max()))
    return err


def headline_spline(B, E, N, n_oracle) -> dict:
    """Cubic-spline fit+eval of B 30x50 surfaces, f32, two routes: the
    library's ``fit_eval_surface`` and the fixed-grid operator path the
    benchmark and the streaming refit use."""
    import jax
    import jax.numpy as jnp
    from iv_engine.ops.spline_matrix import (
        build_surface_operators, fit_eval_surface_grid)
    from iv_engine.surface.surface import fit_eval_surface

    k_row, iv, T = _smiles(B, E, N, 12345)
    iv_bad = (iv + 0.08 * np.sin(20 * k_row)).astype(np.float32)
    k = jnp.broadcast_to(jnp.asarray(k_row), (B, E, N))
    Tb = jnp.broadcast_to(jnp.asarray(T), (B, E))
    lib = jax.jit(lambda v: fit_eval_surface(
        k, v, Tb, method="cubic_spline", n_grid=N, spline_bc="not-a-knot"))
    ops = build_surface_operators(jnp.broadcast_to(jnp.asarray(k_row),
                                                   (E, N)),
                                  jnp.asarray(k_row), bc_type="not-a-knot")
    grid = jax.jit(lambda v: fit_eval_surface_grid(ops, v, jnp.asarray(T)))
    out = {}
    for name, fn in (("library", lib), ("operator", grid)):
        res, first, warm = _timed(fn, jnp.asarray(iv))
        w = np.asarray(res["w_grid"])
        q = (np.asarray(res["k_grid"][0, 0], np.float64) if "k_grid" in res
             else k_row.astype(np.float64))
        err = _oracle_err(w, iv, k_row, T, q, n_oracle)
        clean = float(np.asarray(res["butterfly_ok"]).mean())
        bad = float(np.asarray(fn(jnp.asarray(iv_bad))["butterfly_ok"])
                    .mean())
        check(np.isfinite(w).all(), f"spline {name}: non-finite w_grid")
        check(err <= F32_SPLINE_TOL,
              f"spline {name}: max err {err:.3g} > {F32_SPLINE_TOL}")
        check(clean == 1.0, f"spline {name}: clean butterfly frac {clean}")
        check(bad <= 0.05, f"spline {name}: adversarial frac {bad}")
        out[f"spline_{name}"] = {
            "batch": B, "max_err_vs_scipy_x64": err,
            "butterfly_clean_frac": clean,
            "butterfly_adversarial_frac": bad,
            "first_call_s": first, "warm_call_s": warm,
            "surfaces_per_s_warm": B / warm}
    return out


def parity_spline(B, E, N, n_oracle) -> dict:
    """The --parity path (compensated double-f32) against SciPy x64."""
    import jax
    import jax.numpy as jnp
    from iv_engine.ops.spline_compensated import (
        fit_eval_surface_compensated, queries_df)

    k_row, iv, T = _smiles(B, E, N, 12345)
    k = jnp.asarray(np.broadcast_to(k_row, (E, N)).copy())
    q = queries_df(-1.0, 1.0, N)
    fn = jax.jit(lambda v: fit_eval_surface_compensated(
        k, v, jnp.asarray(T), queries=q))
    res, first, warm = _timed(fn, jnp.asarray(iv))
    w = (np.asarray(res["w_grid"], np.float64)
         + np.asarray(res["w_grid_lo"], np.float64))
    q64 = np.asarray(q[0], np.float64) + np.asarray(q[1], np.float64)
    err = _oracle_err(w, iv, k_row, T, q64, n_oracle)
    check(err <= PARITY_TOL, f"parity: max err {err:.3g} > {PARITY_TOL}")
    return {"parity": {"batch": B, "max_err_vs_scipy_x64": err,
                       "first_call_s": first, "warm_call_s": warm,
                       "surfaces_per_s_warm": B / warm}}


def _ticks(B, L, n_minutes, seed, base=29_000_000):
    rng = np.random.default_rng(seed)
    minute = np.sort(rng.integers(0, n_minutes, (B, L)), axis=-1)
    # every window ends on its last minute, so refits see the full window
    minute[:, -1] = n_minutes - 1
    price = (100.0 * np.exp(np.cumsum(
        rng.normal(0, 2e-4, (B, L)), axis=-1))).astype(np.float32)
    size = rng.uniform(0, 5, (B, L)).astype(np.float32)
    return minute + base, price, size


def phase_stream(B=STREAM_B, L=STREAM_L, n_minutes=STREAM_MIN,
                 bucket=STREAM_BAR, tcp_minutes=8, n_refits=3) -> dict:
    """The streaming refit service: a StreamingSession built as the
    serve daemon builds it, one window of ticks per underlying (the
    last ``tcp_minutes`` arrive through the server's TCP protocol),
    refits requested over TCP, candles compared with a NumPy f64
    aggregation."""
    import pandas as pd
    from iv_engine.config import get_config
    from iv_engine.pipeline.serve import (StreamServer,
                                          build_session,
                                          send_lines)
    from iv_engine.pipeline.storage import MemoryStore

    cfg = get_config()
    session, unds = build_session(cfg, MemoryStore(), n_underlyings=B)
    # the daemon's window is 512 minutes; the CPU tests shrink it
    session.window_minutes = n_minutes
    minute, price, size = _ticks(B, L, n_minutes, seed=7)
    base = int(minute.min())
    late = minute - base >= n_minutes - tcp_minutes
    und = np.repeat(np.asarray(unds, dtype=object), L).reshape(B, L)
    bulk = pd.DataFrame({"underlying": und[~late], "minute": minute[~late],
                         "price": price[~late], "size": size[~late]})
    t0 = time.perf_counter()
    session.ingest_ticks(bulk)
    ingest_s = time.perf_counter() - t0
    server = StreamServer(session, flush_every=1 << 30)
    server.start()
    try:
        lines = [{"underlying": str(u), "minute": int(m), "price": float(p),
                  "size": float(s)} for u, m, p, s in
                 zip(und[late], minute[late], price[late], size[late])]
        t0 = time.perf_counter()
        flush = send_lines("127.0.0.1", server.port,
                           lines + [{"cmd": "flush"}])[-1]
        tcp_ingest_s = time.perf_counter() - t0
        check(flush["ok"] and flush["ingested"] == len(lines),
              f"tcp flush: {flush}")
        refit_s, replies = [], []
        for _ in range(n_refits):
            t0 = time.perf_counter()
            replies += send_lines("127.0.0.1", server.port,
                                  [{"cmd": "refit"}])
            refit_s.append(time.perf_counter() - t0)
        stats = send_lines("127.0.0.1", server.port, [{"cmd": "stats"}])[0]
    finally:
        server.stop()
    check(all(r["ok"] for r in replies), f"refit replies: {replies[:1]}")
    check(stats["ticks_seen"] == B * L, f"stats: {stats}")

    out = session.refit()
    one, five = reference_tick_candles(minute - base, price, size,
                                       n_minutes, bucket)
    errs = {}
    for name, got, ref in (("1m", out.candles_1m, one),
                           ("5m", out.candles_5m, five)):
        got = {f: np.asarray(getattr(got, f)) for f in
               ("open", "high", "low", "close", "volume", "count")}
        nonempty = ref["count"] > 0
        check((got["count"] == ref["count"]).all(), f"{name}: count differs")
        for f in ("open", "high", "low", "close"):
            check((got[f][nonempty] == ref[f][nonempty]).all(),
                  f"{name}: {f} differs from the f64 oracle")
            check(np.isnan(got[f][~nonempty]).all(),
                  f"{name}: empty buckets must be NaN ({f})")
        # bucket sums as f32 prefix-sum differences: |err| <= 4e-7 *
        # window total + 1e-5 per stage (the f64-oracle bound the
        # aggregation tests state); a 5-min bar adds `bucket` 1-min errors
        total = np.abs(size.astype(np.float64)).sum(-1, keepdims=True)
        verr = np.abs(got["volume"] - ref["volume"])
        stages = 1 if name == "1m" else bucket + 1
        bound = stages * (4e-7 * total + 1e-5)
        check((verr <= bound).all(),
              f"{name}: volume err {verr.max():.3g} beyond the f32 bound")
        errs[name] = {"volume_max_abs_err": float(verr.max()),
                      "volume_bound_min": float(bound.min())}
    rv = np.asarray(out.realized_vol)
    tcp_rv = np.asarray([replies[-1]["realized_vol"][u] for u in unds])
    check(np.allclose(tcp_rv, np.round(rv, 6), atol=1e-6),
          "tcp refit realized vol differs from the session's")
    w = np.asarray(out.w_grid)
    check(np.isfinite(w).all() and np.isfinite(rv).all(),
          "non-finite refit grid")
    res = {"underlyings": B, "ticks_per_window": L, "window_minutes":
           n_minutes, "bar_minutes": bucket, "tcp_ticks": len(lines),
           "bulk_ingest_s": ingest_s, "tcp_ingest_s": tcp_ingest_s,
           "refit_s": refit_s,
           "butterfly_ok_frac": float(np.asarray(out.butterfly_ok).mean()),
           "calendar_ok_frac": float(np.asarray(out.calendar_ok).mean()),
           "candles": errs}
    emit("stream", **res)
    return res


def phase_gpu_tests() -> dict:
    """The gpu-marked tests (tests/test_gpu.py), in this process: pytest
    without worker processes, on the card this process already holds
    (JAX_PLATFORMS keeps tests/conftest.py from pinning the CPU)."""
    import pytest
    os.environ["JAX_PLATFORMS"] = "cuda"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_gpu.py")
    outcomes = {"passed": 0, "skipped": 0, "failed": 0}

    class _Tally:
        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                outcomes[report.outcome] += 1

    t0 = time.perf_counter()
    rc = pytest.main([path, "-m", "gpu", "-q", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "-o", "addopts="],
                     plugins=[_Tally()])
    out = {"pytest_exit_code": int(rc), **outcomes,
           "wall_s": time.perf_counter() - t0}
    emit("gpu_tests", **out)
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    check(outcomes["passed"] > 0 and outcomes["skipped"] == 0,
          f"gpu-marked tests did not all run on the card: {outcomes}")
    return out


def _canonical(df, keys):
    drop = [c for c in ("batch_id", "created_at") if c in df.columns]
    df = df.drop(columns=drop).sort_values(keys).reset_index(drop=True)
    for c in df.columns:
        if df[c].dtype == object or str(df[c].dtype).startswith("str"):
            df[c] = df[c].astype(str)
    return df


def phase_four(workdir, n_devices=4, n_symbols=N_SYMBOLS,
               methods=("cubic_spline", "svi", "ah")) -> dict:
    """The pipeline and three surface families sharded over n devices vs
    the same runs pinned to one device: tables must be byte-identical
    (parallel/dryrun.py's criterion)."""
    import jax
    import pandas as pd
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.surface_task import SURFACES

    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    keys = {st.INTERPOLATED: ["symbol", "date"],
            st.MINUTE_CANDLES: ["symbol", "timestamp"],
            st.RECONSTRUCTED: ["symbol", "timestamp", "frequency"],
            SURFACES: ["underlying", "expiry_t", "log_moneyness"]}
    tables, walls = {}, {}
    for shape in (str(n_devices), "1"):
        d = os.path.join(workdir, f"mesh{shape}")
        os.makedirs(d)
        env = {"IVTPU_PROCESSING__MESH_SHAPE": shape}
        run = run_pipeline(d, n_symbols, **env)
        walls[shape] = {"pipeline_s": run["wall_s"]}
        tabs = _tables(run["root"])
        out = {t: _canonical(tabs[t], keys[t]) for t in keys if t in tabs}
        with in_dir(d, **env):
            for m in methods:
                t0 = time.perf_counter()
                _, df = _surface_summary(run["root"], m)
                walls[shape][f"{m}_s"] = time.perf_counter() - t0
                out[f"{SURFACES}/{m}"] = _canonical(df, keys[SURFACES])
        tables[shape] = out
    identical = {}
    for t, a in tables["1"].items():
        b = tables[str(n_devices)][t]
        try:
            pd.testing.assert_frame_equal(a, b, check_exact=True)
            identical[t] = True
        except AssertionError as e:
            identical[t] = str(e).splitlines()[0]
    res = {"device_count": len(jax.devices()), "mesh": n_devices,
           "symbols": n_symbols, "byte_identical": identical,
           "wall_s": walls}
    emit("four", **res)
    check(all(v is True for v in identical.values()),
          f"sharded tables differ: {identical}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-GPU sharded pipeline + surfaces vs "
                         "the same runs on one device")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
              f"this script measures nothing on other platforms",
              file=sys.stderr)
        return 2
    from iv_engine import compile_cache
    compile_cache.enable()

    phase_device()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        if args.four:
            phase_four(td)
        else:
            pipe = phase_pipeline(td)
            phase_surface(pipe["root"], td)
            phase_stream()
            phase_gpu_tests()
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
