"""eSSVI throughput decomposition probe (round-5 verdict item #6).

Hypothesis: with the block-tridiagonal solver the dense (3E)^3
factorization is gone, so the step may no longer be compute-bound — the
remaining wall could be the dependent-kernel chain (32 fori_loop
iterations x (block-Thomas 2E-step scan + ~20 kernels)), in which case
batch width is a lever the dense path never had.

Variants (B=1024, E=30, n=50, 32 iters baseline):
  base      — production bench config
  B2048/B4096 — batch-scaling test (latency-bound => ~linear gain)
  nocal     — calendar_weight=0 (isolates penalty+coupling share)
  pen17     — n_penalty_grid 33 -> 17 (einsum width share)
  dense     — round-2 dense solver reference

One JSON line per variant.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from iv_engine.ops.essvi import essvi_w, fit_essvi_batched

E, n = 30, 50


def gen(seed: int, B: int):
    rng = np.random.default_rng(seed)
    k = np.broadcast_to(np.linspace(-1.2, 1.2, n, dtype=np.float32),
                        (B, E, n)).copy()
    T = np.linspace(0.05, 2.0, E, dtype=np.float32)
    theta = (0.04 + 0.2 * T)[None, :, None] * rng.uniform(
        0.7, 1.3, (B, 1, 1)).astype(np.float32)
    rho = rng.uniform(-0.5, 0.5, (B, 1, 1)).astype(np.float32)
    phi = rng.uniform(0.3, 1.5, (B, 1, 1)).astype(np.float32)
    kk = k
    w = 0.5 * theta * (1.0 + rho * phi * kk
                       + np.sqrt((phi * kk + rho) ** 2 + 1.0 - rho ** 2))
    w = w + rng.normal(0.0, 1e-4, (B, E, n)).astype(np.float32)
    return jnp.asarray(k), jnp.asarray(w.astype(np.float32))


def run(tag: str, B: int, **kw) -> None:
    fit = jax.jit(lambda k, w: fit_essvi_batched(k, w, max_iters=32, **kw))
    inputs = [gen(100 + i, B) for i in range(3)]
    for args in inputs:
        jax.block_until_ready(args)
    t0 = time.time()
    res = jax.block_until_ready(fit(*inputs[0]))
    compile_s = time.time() - t0
    ts = []
    for i in range(3):
        args = inputs[i % 3]
        t0 = time.perf_counter()
        jax.block_until_ready(fit(*args))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    k, w = inputs[0]
    rmse = float(jnp.sqrt(jnp.mean((essvi_w(res.params, k) - w) ** 2)))
    print(json.dumps({"variant": tag, "B": B,
                      "surfaces_per_sec": round(B / dt, 1),
                      "step_ms": round(dt * 1e3, 1),
                      "compile_s": round(compile_s, 1),
                      "rmse": round(rmse, 8), **{k: str(v) for k, v in
                                                 kw.items()}}),
          flush=True)


if __name__ == "__main__":
    only = sys.argv[1:] or ["base", "B2048", "B4096", "nocal", "pen17",
                            "dense"]
    print(f"backend: {jax.default_backend()}", file=sys.stderr, flush=True)
    if "base" in only:
        run("base", 1024)
    if "B2048" in only:
        run("B2048", 2048)
    if "B4096" in only:
        run("B4096", 4096)
    if "nocal" in only:
        run("nocal", 1024, calendar_weight=0.0)
    if "pen17" in only:
        run("pen17", 1024, n_penalty_grid=17)
    if "dense" in only:
        run("dense", 1024, solver="dense")
