"""Benchmark: vol-surface fit+eval throughput and the other engine cells.

Metric (BASELINE.json): surfaces/sec, fit + evaluate on a 30x50
strike-maturity grid — cubic-spline smiles in total variance, dense-grid
eval, butterfly/calendar diagnostics, all on-device. North-star target:
10,000 surfaces/sec (``vs_baseline`` = measured / 10,000).

Uses the matrix-form spline path (``ops.spline_matrix``): on a fixed
strike grid the whole fit+eval is three contractions. Operator
construction is one-off setup amortised over the stream and excluded
from the timed region (it is itself jitted and takes ~n^3 once).

Timing: every timed call gets fresh input buffers generated on the
device from fresh seeds (no host->device staging in the loop), waits
with ``block_until_ready``, and reports the median over calls. Batch
sizes are kept from the earlier accelerator until the GPU cells are
re-sized (ROADMAP S1).

One process runs every stage in order; a failing stage is reported on
stderr and the others still run. Exactly one JSON line goes to stdout.
``IVTPU_BENCH_SMOKE=1`` runs tiny shapes (a CPU self-test).
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from iv_engine import compile_cache

TARGET = 10_000.0  # surfaces/sec north star (BASELINE.md)
E, N_K, N_GRID = 30, 50, 50
SMOKE = os.environ.get("IVTPU_BENCH_SMOKE", "") == "1"


def _iv_gen(B, k_row):
    """Jitted on-device batch generator: seed -> (B, E, N_K) smiles."""
    kk = jnp.asarray(k_row)[None, None, :]

    @jax.jit
    def gen(seed):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        atm = jax.random.uniform(k1, (B, 1, 1), jnp.float32, 0.15, 0.6)
        curv = jax.random.uniform(k2, (B, 1, 1), jnp.float32, 0.05, 0.3)
        noise = 1e-4 * jax.random.normal(k3, (B, E, N_K), jnp.float32)
        return atm + curv * kk * kk + noise

    return gen


def _median_time(fn, inputs):
    """Median wall time of fn over fresh inputs (last one warms up)."""
    jax.block_until_ready(fn(*inputs[-1]))
    times = []
    for args in inputs[:-1]:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def bench_spline(rng, batch_sizes=(32768, 131072)):
    from iv_engine.ops.spline_matrix import (
        build_surface_operators, fit_eval_surface_grid)

    k_row = np.linspace(-1.0, 1.0, N_K, dtype=np.float32)
    knots = jnp.asarray(np.broadcast_to(k_row, (E, N_K)).copy())
    queries = jnp.asarray(np.linspace(-1.0, 1.0, N_GRID, dtype=np.float32))
    T = jnp.asarray(np.linspace(0.05, 2.0, E, dtype=np.float32))

    # not-a-knot: same operator shapes/FLOPs as natural, but no spurious
    # edge butterfly flags on smooth smiles (tests/test_spline_matrix.py)
    ops = build_surface_operators(knots, queries,
                                  bc_type="not-a-knot")  # setup, amortised
    jax.block_until_ready(ops)

    def step(iv):
        out = fit_eval_surface_grid(ops, iv, T)
        return out["w_grid"], out["butterfly_ok"], out["calendar_ok"]

    step_jit = jax.jit(step)

    best, best_B = 0.0, 0
    for B in batch_sizes:
        gen = _iv_gen(B, k_row)
        seed0 = int(rng.integers(0, 2**31 - 16))
        inputs = [(gen(seed0 + i),) for i in range(6)]
        for (x,) in inputs:
            jax.block_until_ready(x)
        dt = _median_time(step_jit, inputs)
        del inputs  # free ~4.7 GB of resident batches before the next size
        sps = B / dt
        if sps > best:
            best, best_B = sps, B
    return best, best_B, _spline_accuracy(step_jit, k_row, np.asarray(T))


def _spline_accuracy(step_jit, k_row, T_host):
    """Accuracy telemetry for the headline path: a silent numeric
    regression — e.g. a contraction dropping to reduced precision
    (PERF.md "Precision") — would leave surfaces/s green while every
    value and flag goes wrong.

    Returns dict with:
      * ``parity_max_err``: max |w_grid - SciPy x64 oracle| over a
        64-surface sub-batch (not-a-knot CubicSpline on w = iv^2 T);
      * ``butterfly_clean_frac``: fraction of noiseless convex smiles
        flagged butterfly-free (should be 1.0 — this is exactly the
        check that failed before the HIGHEST-precision fix);
      * ``butterfly_adversarial_frac``: fraction of deliberately
        arbitrage-laden (high-frequency wiggle) surfaces flagged clean
        (should be ~0.0 — catches flags stuck at True).
    """
    Bs = 64
    rng = np.random.default_rng(12345)  # fixed: parity needs no fresh seeds
    atm = rng.uniform(0.15, 0.6, (Bs, 1, 1))
    curv = rng.uniform(0.05, 0.3, (Bs, 1, 1))
    kk = k_row[None, None, :]
    iv_clean = np.broadcast_to(atm + curv * kk * kk,
                               (Bs, E, N_K)).astype(np.float32)
    w_dev, bfly_clean, _ = step_jit(jnp.asarray(iv_clean))
    w_dev = np.asarray(w_dev)

    parity = 0.0
    try:
        from scipy.interpolate import CubicSpline
        q = np.linspace(-1.0, 1.0, N_GRID)
        for b in range(0, Bs, 8):            # sample 8 surfaces of 64
            for e in range(0, E, 6):
                w_knots = (iv_clean[b, e].astype(np.float64) ** 2
                           * float(T_host[e]))
                ref = CubicSpline(k_row.astype(np.float64), w_knots,
                                  bc_type="not-a-knot")(q)
                parity = max(parity, float(
                    np.abs(w_dev[b, e] - ref).max()))
    except ImportError:                       # pragma: no cover
        parity = None                          # JSON null, not NaN

    # adversarial: wiggles at the grid scale carry butterfly arbitrage
    iv_bad = (iv_clean + 0.08 * np.sin(20 * kk)).astype(np.float32)
    _, bfly_bad, _ = step_jit(jnp.asarray(iv_bad))
    return {
        "parity_max_err": parity,
        "butterfly_clean_frac": float(np.asarray(bfly_clean).mean()),
        "butterfly_adversarial_frac": float(np.asarray(bfly_bad).mean()),
    }


def bench_parity(rng, B=32768):
    """Compensated (double-f32) spline fit+eval — the CLI ``--parity``
    mode (ops/spline_compensated.py, config ``surface.compensated``).

    The fast f32 path bottoms out at ulp/2 ~ 6e-8 near w ~ 1.6, which
    can never meet BASELINE.md's <=1e-8 oracle target; the df64 pair
    ``f64(w_grid) + f64(w_grid_lo)`` reproduces the SciPy x64 oracle to
    ~1e-9 (tests/test_spline_compensated.py). This stage measures BOTH
    the deliverable-path parity on the chip and its throughput, so the
    cost of parity mode is quoted next to the headline fast path.

    Returns (surfaces/s, max |hi+lo - oracle| over a 64-surface clean
    sub-batch, oracle evaluated at the df64 query positions q_hi+q_lo).
    """
    from iv_engine.ops.spline_compensated import (
        fit_eval_surface_compensated, queries_df)

    k_row = np.linspace(-1.0, 1.0, N_K, dtype=np.float32)
    k = jnp.asarray(np.broadcast_to(k_row, (E, N_K)).copy())
    T = jnp.asarray(np.linspace(0.05, 2.0, E, dtype=np.float32))
    q = queries_df(-1.0, 1.0, N_GRID)

    def step(iv):
        out = fit_eval_surface_compensated(k, iv, T, queries=q)
        return (out["w_grid"], out["w_grid_lo"],
                out["butterfly_ok"], out["calendar_ok"])

    step_jit = jax.jit(step)
    gen = _iv_gen(B, k_row)
    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [(gen(seed0 + i),) for i in range(6)]
    for (x,) in inputs:
        jax.block_until_ready(x)
    dt = _median_time(step_jit, inputs)
    del inputs
    sps = B / dt

    # oracle parity on the same clean-smile population as the fast path
    Bs = 64
    prng = np.random.default_rng(12345)
    atm = prng.uniform(0.15, 0.6, (Bs, 1, 1))
    curv = prng.uniform(0.05, 0.3, (Bs, 1, 1))
    kk = k_row[None, None, :]
    iv_clean = np.broadcast_to(atm + curv * kk * kk,
                               (Bs, E, N_K)).astype(np.float32)
    w_hi, w_lo, _, _ = step_jit(jnp.asarray(iv_clean))
    w64 = np.asarray(w_hi, np.float64) + np.asarray(w_lo, np.float64)
    q64 = (np.asarray(q[0], np.float64) + np.asarray(q[1], np.float64))
    T_host = np.linspace(0.05, 2.0, E, dtype=np.float32)

    parity = 0.0
    try:
        from scipy.interpolate import CubicSpline
        for b in range(0, Bs, 4):
            for e in range(E):
                w_knots = (iv_clean[b, e].astype(np.float64) ** 2
                           * float(T_host[e]))
                ref = CubicSpline(k_row.astype(np.float64), w_knots,
                                  bc_type="not-a-knot")(q64)
                parity = max(parity, float(np.abs(w64[b, e] - ref).max()))
    except ImportError:                       # pragma: no cover
        parity = None
    return sps, parity


def bench_rbf(rng, B=8, N=2048, n_iters=24, n_centers=None):
    # 24 iters: 16 repaired only ~75-100% of the arbitrage-laden batch
    # (seed-dependent); 24 is the knee where arbfree_frac is 1.0 across
    # seeds
    """Arbitrage-penalized RBF at the north-star scale (BASELINE config
    #4: ~2k scattered quotes with no-arbitrage penalty smoothing) — B
    surfaces fitted as one vmapped damped-GN solve, flags reported from
    the penalty grid. Returns (surfaces_per_sec, arbfree_frac)."""
    from iv_engine.ops.rbf import fit_eval_rbf_arbfree_batched

    @jax.jit
    def gen(seed):
        ks = jax.random.split(jax.random.PRNGKey(seed), 3)
        kq = jax.random.uniform(ks[0], (B, N), jnp.float32, -1.0, 1.0)
        Tq = jax.random.uniform(ks[1], (B, N), jnp.float32, 0.05, 2.0)
        w = (0.04 + 0.3 * kq * kq) * Tq \
            + 0.01 * jnp.sin(8.0 * kq) * Tq       # arbitrage-laden quotes
        pts = jnp.stack([kq, Tq], axis=-1)
        return pts, w

    def step(pts, w):
        return fit_eval_rbf_arbfree_batched(
            pts, w, pts[:, :64], smoothing=1e-8, n_iters=n_iters,
            n_centers=n_centers)

    step_jit = jax.jit(step)
    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [gen(seed0 + i) for i in range(4)]
    for args in inputs:
        jax.block_until_ready(args)
    dt = _median_time(step_jit, inputs)
    _, bok, cok = step_jit(*inputs[0])
    frac = float((np.asarray(bok) & np.asarray(cok)).mean())
    return B / dt, frac


def bench_svi(rng, B=1024, n_iters=32, unroll=False):
    """SVI calibration at the production shape — B surfaces x 30 slices
    (BASELINE config #3 "30 slices x thousands of surfaces") with the
    quasi-explicit init. Returns (slices_per_sec, mean_rmse)."""
    from iv_engine.ops.svi import (fit_svi_batched,
                                   svi_total_variance)

    n = N_K
    k_row = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    k_dev = jnp.asarray(np.broadcast_to(k_row, (B, E, n)).copy())

    @jax.jit
    def gen_w(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), 6)
        U = lambda key, lo, hi: jax.random.uniform(
            key, (B, E, 1), jnp.float32, lo, hi)
        a, b = U(keys[0], 0.01, 0.08), U(keys[1], 0.05, 0.3)
        rho, m = U(keys[2], -0.6, 0.6), U(keys[3], -0.2, 0.2)
        sig = U(keys[4], 0.1, 0.5)
        kk = jnp.asarray(k_row)[None, None, :]
        w = a + b * (rho * (kk - m) + jnp.sqrt((kk - m) ** 2 + sig ** 2))
        return w + 1e-4 * jax.random.normal(keys[5], (B, E, n), jnp.float32)

    seed0 = int(rng.integers(0, 2**31 - 16))

    def make_inputs(i):
        return k_dev, gen_w(seed0 + i)

    fit = jax.jit(lambda k, w: fit_svi_batched(
        k, w, max_iters=n_iters, init="quasi", unroll=unroll))
    inputs = [make_inputs(i) for i in range(4)]
    for args in inputs:
        jax.block_until_ready(args)
    dt = _median_time(fit, inputs)
    res = fit(*inputs[0])
    k, w = inputs[0]
    pred = svi_total_variance(res.params, k)
    rmse = float(jnp.sqrt(jnp.mean((pred - w) ** 2)))
    return B * E / dt, rmse


def bench_essvi(rng, B=1024, n_iters=32):
    """eSSVI global surface calibration at the production shape — one
    joint 3E-parameter LM per surface (theta increasing + butterfly-free
    slices by construction, ops/essvi.py). Uses the block-tridiagonal
    slice-space solver (solver='block' default): O(E) closed-form 3x3
    solves replace the dense P=90 Cholesky that dominated the dense
    path's step. Returns (surfaces_per_sec, mean_rmse)."""
    from iv_engine.ops.essvi import essvi_w, fit_essvi_batched

    n = N_K
    k_row = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    k_dev = jnp.asarray(np.broadcast_to(k_row, (B, E, n)).copy())

    @jax.jit
    def gen_w(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), 5)
        th0 = jax.random.uniform(keys[0], (B, E), jnp.float32, 0.005, 0.03)
        theta = jnp.cumsum(th0, axis=-1)
        rho = jax.random.uniform(keys[1], (B, 1), jnp.float32, -0.6, 0.6)
        rho = jnp.broadcast_to(rho, (B, E))
        frac = jnp.broadcast_to(
            jax.random.uniform(keys[2], (B, 1), jnp.float32, 0.2, 0.7),
            (B, E))
        from iv_engine.ops.essvi import psi_butterfly_cap
        params = jnp.stack(
            [theta, rho, psi_butterfly_cap(theta, rho) * frac], axis=-1)
        w = essvi_w(params, k_dev)
        return w + 1e-4 * jax.random.normal(keys[3], (B, E, n), jnp.float32)

    seed0 = int(rng.integers(0, 2**31 - 16))
    fit = jax.jit(lambda k, w: fit_essvi_batched(k, w, max_iters=n_iters))
    inputs = [(k_dev, gen_w(seed0 + i)) for i in range(4)]
    for args in inputs:
        jax.block_until_ready(args)
    dt = _median_time(fit, inputs)
    res = fit(*inputs[0])
    rmse = float(jnp.sqrt(jnp.mean(
        (essvi_w(res.params, k_dev) - inputs[0][1]) ** 2)))
    return B / dt, rmse


def bench_streaming(rng, B=1024, L_ticks=4096, n_minutes=512):
    """Streaming chain (ticks -> 1-min -> 5-min -> surface refit) per
    underlying — BASELINE config #5's 1k-underlying streaming batch."""
    from iv_engine.pipeline.streaming import streaming_step

    E_s, n_s, m = 4, 12, 50
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n_s), (B, E_s, n_s))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E_s), (B, E_s))
    iv = 0.5 + 0.05 * k * k
    # fixed session grids -> precomputed spline operators (one-off setup
    # amortised over the stream, like a StreamingSession)
    from iv_engine.ops.spline_matrix import (
        build_surface_operators_batched)
    from iv_engine.surface.surface import common_support_grid
    ops = build_surface_operators_batched(
        k, common_support_grid(k, m), bc_type="not-a-knot")
    jax.block_until_ready(ops)

    @jax.jit
    def make_inputs(seed):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        minute = jnp.sort(jax.random.randint(
            k1, (B, L_ticks), 0, n_minutes, jnp.int32), axis=-1)
        price = 100 + jnp.cumsum(
            0.01 * jax.random.normal(k2, (B, L_ticks), jnp.float32),
            axis=-1)
        size = jax.random.uniform(k3, (B, L_ticks), jnp.float32, 0, 5)
        valid = jnp.ones((B, L_ticks), bool)
        return minute, price, size, valid

    step = jax.jit(lambda mi, p, s, v: streaming_step(
        mi, p, s, v, k, iv, T, n_minutes=n_minutes, n_grid=m,
        spline_ops=ops))
    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [make_inputs(seed0 + i) for i in range(4)]
    for args in inputs:
        jax.block_until_ready(args)
    dt = _median_time(step, inputs)
    return B / dt


def bench_ah(rng, B=512, n_iters=16, n_grid=257):
    """Andreasen-Huge one-step surfaces (method 'ah'): per-slice LM over
    implicit Dupire steps, arbitrage-free by construction
    (ops/andreasen_huge.py). Arbitrage-LADEN quotes (ATM spike) prove
    the structural guarantee every bench run. B=512 is the production
    batch (``surface.ah_max_batch``). Returns
    (surfaces_per_sec, arbfree_frac, price_rmse)."""
    from iv_engine.ops.andreasen_huge import fit_eval_ah_surface

    E_a, m = 8, 16
    k = jnp.asarray(np.broadcast_to(
        np.linspace(-0.6, 0.6, m, dtype=np.float32), (B, E_a, m)).copy())
    T = jnp.asarray(np.broadcast_to(
        np.linspace(0.08, 1.5, E_a, dtype=np.float32), (B, E_a)).copy())

    @jax.jit
    def gen_iv(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), 2)
        lvl = jax.random.uniform(keys[0], (B, 1, 1), jnp.float32,
                                 0.18, 0.30)
        iv = lvl + 0.1 * k * k + 0.02 * jnp.sqrt(T)[..., None]
        spike = jnp.zeros((m,), jnp.float32).at[m // 2].set(0.4)
        return iv * (1.0 + spike)          # butterfly-violating quotes

    fit = jax.jit(lambda iv: fit_eval_ah_surface(
        k, iv, T, n_grid=n_grid, n_iters=n_iters))
    seed0 = int(rng.integers(0, 2**31 - 16))
    inputs = [(gen_iv(seed0 + i),) for i in range(4)]
    for args in inputs:
        jax.block_until_ready(args)
    dt = _median_time(fit, inputs)
    out = fit(*inputs[0])
    frac = float((np.asarray(out["butterfly_ok"])
                  & np.asarray(out["calendar_ok"])).mean())
    rmse = float(np.asarray(out["fit_rmse"]).max())
    return B / dt, frac, rmse


# ---------------------------------------------------------------------------
# Stage registry: each stage runs independently; a failing stage does not
# forfeit the others' metrics.

def _stage_spline(rng):
    sizes = (512,) if SMOKE else (32768, 131072)
    best, best_B, acc = bench_spline(rng, batch_sizes=sizes)
    return {"value": round(best, 1), "batch": best_B, **acc}


def _stage_svi(rng):
    sps, rmse = (bench_svi(rng, B=16, n_iters=4) if SMOKE
                 else bench_svi(rng))
    return {"value": round(sps, 1), "rmse": round(rmse, 6)}


def _stage_essvi(rng):
    sps, rmse = (bench_essvi(rng, B=16, n_iters=4) if SMOKE
                 else bench_essvi(rng))
    return {"value": round(sps, 1), "rmse": round(rmse, 6)}


def _stage_parity(rng):
    sps, err = (bench_parity(rng, B=512) if SMOKE
                else bench_parity(rng))
    return {"value": round(sps, 1),
            "max_err_vs_x64_oracle": (
                None if err is None else float(f"{err:.3g}"))}


def _stage_streaming(rng):
    ups = (bench_streaming(rng, B=8, L_ticks=256, n_minutes=64) if SMOKE
           else bench_streaming(rng))
    return {"value": round(ups, 1)}


def _stage_rbf(rng):
    sps, frac = (bench_rbf(rng, B=2, N=128, n_iters=2) if SMOKE
                 else bench_rbf(rng))
    return {"value": round(sps, 2), "arbfree_frac": frac}


def _stage_rbf_reduced(rng):
    """Least-squares reduced basis (n_centers=512 over 2048 quotes,
    ops/rbf.py): same hinge repair, (c+p)^3 KKT factorizations; the
    exact every-site-a-center stage above stays the config-#4
    headline."""
    if SMOKE:
        sps, frac = bench_rbf(rng, B=2, N=128, n_iters=2, n_centers=32)
        return {"value": round(sps, 2), "arbfree_frac": frac}
    sps, frac = bench_rbf(rng, B=64, n_centers=512)
    return {"value": round(sps, 2), "arbfree_frac": frac}


def _stage_ah(rng):
    sps, frac, rmse = (bench_ah(rng, B=2, n_iters=2, n_grid=65) if SMOKE
                       else bench_ah(rng))
    return {"value": round(sps, 1), "arbfree_frac": frac,
            "price_rmse": float(f"{rmse:.3g}")}


STAGES = (
    ("spline", _stage_spline),
    ("parity", _stage_parity),
    ("svi", _stage_svi),
    ("essvi", _stage_essvi),
    ("streaming", _stage_streaming),
    ("rbf", _stage_rbf),
    ("rbf_reduced", _stage_rbf_reduced),
    ("ah", _stage_ah),
)

_EXTRA_NAMES = {
    "parity": "parity_df64_surfaces_per_sec_fit_eval_30x50",
    "svi": "svi_lm_slices_per_sec_1024x30_quasi32",
    "essvi": "essvi_surfaces_per_sec_1024x30x50_iters32",
    "streaming": "streaming_refit_underlyings_per_sec_1024",
    "rbf": "rbf_arbfree_surfaces_per_sec_8x2048_iters24",
    "rbf_reduced": "rbf_arbfree_reduced_c512_surfaces_per_sec_64x2048_iters24",
    "ah": "ah_surfaces_per_sec_512x8x16_grid257_iters16",
}
_EXTRA_UNITS = {"parity": "surfaces/s",
                "svi": "slices/s", "essvi": "surfaces/s",
                "streaming": "underlyings/s", "rbf": "surfaces/s",
                "rbf_reduced": "surfaces/s", "ah": "surfaces/s"}


def _assemble(stages):
    """Build the single output JSON object from completed stages."""
    sp = stages.get("spline")
    if sp is None:
        return None
    out = {
        "metric": "surfaces_per_sec_fit_eval_30x50",
        "value": sp["value"],
        "unit": "surfaces/s",
        "vs_baseline": round(sp["value"] / TARGET, 3),
        "batch": sp["batch"],
        # accuracy telemetry: throughput alone would stay green through
        # a silent numeric regression (the reduced-precision class of
        # bug) — these fields pin values AND flags every bench run
        # headline parity is the DELIVERABLE parity path (CLI --parity,
        # compensated df64 — the <=1e-8 north star); the fast f32
        # path's own envelope stays visible as parity_fast_f32_max_err
        "parity_max_err_vs_x64_oracle": (
            stages["parity"].get("max_err_vs_x64_oracle")
            if "parity" in stages
            else (None if sp.get("parity_max_err") is None
                  else float(f"{sp['parity_max_err']:.3g}"))),
        "parity_fast_f32_max_err": (
            None if sp.get("parity_max_err") is None
            else float(f"{sp['parity_max_err']:.3g}")),
        "butterfly_clean_frac": sp.get("butterfly_clean_frac"),
        "butterfly_adversarial_frac": sp.get("butterfly_adversarial_frac"),
    }
    extras, missing = [], []
    for name, _fn in STAGES[1:]:
        res = stages.get(name)
        if res is None:
            missing.append(_EXTRA_NAMES[name])
            continue
        extra = {"metric": _EXTRA_NAMES[name], "value": res["value"],
                 "unit": _EXTRA_UNITS[name]}
        for key in ("rmse", "arbfree_frac", "price_rmse",
                    "max_err_vs_x64_oracle"):
            if key in res:
                extra[key] = res[key]
        extras.append(extra)
    out["extra_metrics"] = extras
    if missing:
        out["incomplete_metrics"] = missing
    return out


def main():
    compile_cache.enable()
    dev = jax.devices()[0]
    rng = np.random.default_rng(time.time_ns() % 2**31)
    stages, failed = {}, []
    for name, fn in STAGES:
        t0 = time.time()
        try:
            stages[name] = fn(rng)
        except Exception:  # noqa: BLE001 — stage isolation
            import traceback
            print(f"# stage {name}: FAILED after {time.time() - t0:.0f}s",
                  file=sys.stderr, flush=True)
            traceback.print_exc()
            failed.append(name)
            continue
        print(f"# stage {name}: done in {time.time() - t0:.0f}s -> "
              f"{stages[name]}", file=sys.stderr, flush=True)
    out = _assemble(stages)
    if out is not None:
        out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}
        print(json.dumps(out), flush=True)
    return 1 if failed or out is None else 0


if __name__ == "__main__":
    sys.exit(main())
