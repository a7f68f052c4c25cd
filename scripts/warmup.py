"""Prefill the persistent XLA compilation cache for production shapes.

First compiles cost seconds to minutes per kernel shape; running this
once after deployment (or a config change to bucket_sizes / batch_size)
makes every subsequent pipeline run start warm. The cache directory is
``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``.

Usage:  python scripts/warmup.py [--env production]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="production")
    args = ap.parse_args()
    os.environ["ENVIRONMENT"] = args.env

    import jax
    from iv_engine import compile_cache
    compile_cache.enable()

    import numpy as np
    from iv_engine.config import get_config
    from iv_engine.pipeline import MemoryStore, PipelineRunner
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.sample_data import (
        generate_sample_tickers)

    cfg = get_config()
    maxb = cfg.processing.batch_size
    print(f"warming kernels for env={args.env} "
          f"(batch={maxb}, buckets={cfg.processing.bucket_sizes})",
          flush=True)

    t0 = time.time()
    # one full-batch-sized fused run per common bucket shape: 24h hourly
    # chains land in the 4096 bucket; the padded batch dims {16,...,maxb}
    # warm from a single maxb-sized universe
    store = MemoryStore()
    store.write(st.TICKERS,
                generate_sample_tickers(num_symbols=maxb, hours=24))
    runner = PipelineRunner(cfg, store=store)
    runner.run_pipeline_fused()
    print(f"fused pipeline kernels warm ({time.time() - t0:.0f}s)",
          flush=True)

    t0 = time.time()
    from iv_engine.ops.spline_matrix import (
        build_surface_operators, fit_eval_surface_grid)
    import jax.numpy as jnp
    E, n, m = 30, 50, 50
    knots = jnp.asarray(np.broadcast_to(
        np.linspace(-1, 1, n, dtype=np.float32), (E, n)).copy())
    ops = build_surface_operators(
        knots, jnp.linspace(-1, 1, m, dtype=jnp.float32),
        bc_type="not-a-knot")  # bench.py's operator variant
    for B in (32768, 131072):
        iv = jnp.ones((B, E, n), jnp.float32) * 0.3
        out = fit_eval_surface_grid(
            ops, iv, jnp.linspace(0.05, 2.0, E, dtype=jnp.float32))
        jax.block_until_ready(out["w_grid"])
    print(f"surface benchmark kernels warm ({time.time() - t0:.0f}s)",
          flush=True)

    # bench.py's SVI / eSSVI / streaming configurations
    t0 = time.time()
    import bench
    rng = np.random.default_rng(0)
    bench.bench_svi(rng)
    bench.bench_essvi(rng)
    bench.bench_streaming(rng)
    print(f"svi/essvi/streaming benchmark kernels warm "
          f"({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
