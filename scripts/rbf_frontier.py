"""RBF exact-vs-reduced frontier: held-out accuracy and device throughput.

Round-5 verdict item #3: publish the accuracy/speed frontier of the
reduced-center (least-squares) arbitrage-penalized RBF so the default
basis size is a measured decision, not a guess.

Stages (run on the chip; results go to PERF.md):

  accuracy — B=8 surfaces, 2048 training quotes + 512 held-out quotes
    drawn from a smooth arbitrage-free SVI-in-k / linear-in-T ground
    truth with observation noise; fit exact and c in {1024, 512, 256}
    with production penalty weights and report held-out RMSE vs the
    noisy quotes AND vs the noise-free truth, plus arbfree_frac.
  speed — bench-shaped arbitrage-laden fits (the bench_rbf generator),
    sweeping (n_centers, B) to find the throughput frontier at
    arbfree_frac 1.0.

Usage: python scripts/rbf_frontier.py [accuracy|speed] ...
Each result prints as one JSON line tagged with its config.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from iv_engine.ops.rbf import fit_eval_rbf_arbfree_batched


def emit(tag: str, payload: dict) -> None:
    print(json.dumps({"stage": tag, **payload}), flush=True)


def _median_time(fn, inputs, n=3):
    ts = []
    for i in range(n):
        args = inputs[i % len(inputs)]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def gen_truth(seed: int, B: int, n_train: int, n_test: int):
    """Smooth no-arb ground truth: SVI smile in k, linear total-variance
    growth in T (calendar-increasing by construction), plus iid
    observation noise on the training quotes only."""
    rng = np.random.default_rng(seed)
    N = n_train + n_test
    k = rng.uniform(-1.0, 1.0, (B, N)).astype(np.float32)
    T = rng.uniform(0.05, 2.0, (B, N)).astype(np.float32)
    rho = rng.uniform(-0.5, 0.5, (B, 1)).astype(np.float32)
    m = rng.uniform(-0.15, 0.15, (B, 1)).astype(np.float32)
    sig = rng.uniform(0.15, 0.45, (B, 1)).astype(np.float32)
    b = rng.uniform(0.05, 0.12, (B, 1)).astype(np.float32)
    smile = 0.04 + b * (rho * (k - m) + np.sqrt((k - m) ** 2 + sig ** 2))
    w_true = smile * T
    noise = rng.normal(0.0, 1.0, (B, N)).astype(np.float32) * 5e-4
    pts = np.stack([k, T], axis=-1)
    return (pts[:, :n_train], (w_true + noise)[:, :n_train],
            pts[:, n_train:], w_true[:, n_train:],
            (w_true + noise)[:, n_train:])


def stage_accuracy(seed: int = 20260820) -> None:
    B, n_train, n_test, n_iters = 8, 2048, 512, 24
    p_tr, w_tr, p_te, w_te_true, w_te_noisy = gen_truth(seed, B,
                                                        n_train, n_test)
    for c in (None, 1024, 512, 256):
        fit = jax.jit(lambda p, v, q, c=c: fit_eval_rbf_arbfree_batched(
            p, v, q, smoothing=1e-8, n_iters=n_iters, n_centers=c))
        w_q, bok, cok = fit(jnp.asarray(p_tr), jnp.asarray(w_tr),
                            jnp.asarray(p_te))
        w_q = np.asarray(jax.block_until_ready(w_q))
        rmse_true = float(np.sqrt(np.mean((w_q - w_te_true) ** 2)))
        rmse_noisy = float(np.sqrt(np.mean((w_q - w_te_noisy) ** 2)))
        emit("accuracy", {
            "n_centers": c or 0, "B": B, "n_train": n_train,
            "n_test": n_test, "n_iters": n_iters,
            "holdout_rmse_vs_truth": round(rmse_true, 8),
            "holdout_rmse_vs_noisy_quotes": round(rmse_noisy, 8),
            "noise_floor": 5e-4,
            "arbfree_frac": float((np.asarray(bok)
                                   & np.asarray(cok)).mean())})


def stage_speed(seed: int = 7) -> None:
    """bench_rbf-shaped throughput sweep (arbitrage-laden quotes)."""
    N, n_iters = 2048, 24
    for c, B in ((512, 64), (512, 128), (512, 256),
                 (256, 64), (256, 128), (256, 256)):
        @jax.jit
        def gen(s, B=B):
            ks = jax.random.split(jax.random.PRNGKey(s), 2)
            kq = jax.random.uniform(ks[0], (B, N), jnp.float32, -1.0, 1.0)
            Tq = jax.random.uniform(ks[1], (B, N), jnp.float32, 0.05, 2.0)
            w = (0.04 + 0.3 * kq * kq) * Tq + 0.01 * jnp.sin(8.0 * kq) * Tq
            return jnp.stack([kq, Tq], axis=-1), w

        fit = jax.jit(lambda p, v, c=c: fit_eval_rbf_arbfree_batched(
            p, v, p[:, :64], smoothing=1e-8, n_iters=n_iters, n_centers=c))
        inputs = [gen(seed + i) for i in range(3)]
        for args in inputs:
            jax.block_until_ready(args)
        t0 = time.time()
        jax.block_until_ready(fit(*inputs[0]))   # compile
        compile_s = time.time() - t0
        dt = _median_time(fit, inputs)
        _, bok, cok = fit(*inputs[0])
        emit("speed", {
            "n_centers": c, "B": B, "N": N, "n_iters": n_iters,
            "surfaces_per_sec": round(B / dt, 1),
            "compile_s": round(compile_s, 1),
            "arbfree_frac": float((np.asarray(bok)
                                   & np.asarray(cok)).mean())})


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "accuracy"
    print(f"backend: {jax.default_backend()}", file=sys.stderr, flush=True)
    {"accuracy": stage_accuracy, "speed": stage_speed}[which]()
