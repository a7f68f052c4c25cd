"""iv_engine — GPU implied-volatility surface & market-data engine (JAX).

A brand-new JAX/XLA framework with the capabilities of the
liu-wei2021/IV_INTERPOLATION reference pipeline (hourly IV -> 1-min
interpolation -> synthetic OHLCV bridge -> 5-min candle reconstruction,
with batch orchestration, checkpoint/resume and monitoring), re-designed
for an accelerator (an NVIDIA GPU):

  * the interpolation engine is a batched, masked, jit/vmap-compiled
    resampler over fixed-shape padded grids (``ops.interp``);
  * the general surface engine fits cubic-spline smiles (PCR/scan
    tridiagonal solves), SVI slices (batched Levenberg-Marquardt) and
    RBF surfaces (batched Cholesky) — ``ops`` + ``surface``;
  * candle aggregation is a segment-reduction kernel over device-resident
    buffers (``ops.segment_ohlcv``);
  * the synthetic-OHLCV bridge uses counter-based ``jax.random`` keys for
    reproducibility (``ops.bridge``);
  * scaling is data-parallel sharding of the surface batch over a
    ``jax.sharding.Mesh`` (``parallel``), not process pools.

See SURVEY.md for the reference layer map this framework mirrors.
"""

__version__ = "0.1.0"

from iv_engine.config import (  # noqa: F401
    Config,
    get_config,
)

__all__ = [
    "Config", "get_config", "__version__",
]


def __getattr__(name):
    """Lazy top-level API: keep ``import iv_engine`` light
    (no jax/pandas import cost) while exposing the main entry points."""
    lazy = {
        "fit_surface": ("iv_engine.surface", "fit_surface"),
        "eval_surface": ("iv_engine.surface", "eval_surface"),
        "fit_eval_surface": ("iv_engine.surface",
                             "fit_eval_surface"),
        "PipelineRunner": ("iv_engine.pipeline",
                           "PipelineRunner"),
        "RunManifest": ("iv_engine.pipeline", "RunManifest"),
        "get_store": ("iv_engine.pipeline", "get_store"),
    }
    if name in lazy:
        import importlib
        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'iv_engine' has no attribute {name!r}")
