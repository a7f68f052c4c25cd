"""Orbax surface-state checkpointing round-trips."""

import jax.numpy as jnp
import numpy as np

from iv_engine.pipeline.checkpoint import (
    restore_state,
    restore_surface_fit,
    save_state,
    save_surface_fit,
)
from iv_engine.surface.surface import eval_surface, fit_surface


def test_state_roundtrip(tmp_path, rng):
    state = {"params": jnp.asarray(rng.normal(size=(8, 5))),
             "cost": jnp.asarray(rng.uniform(size=(8,)))}
    p = save_state(str(tmp_path / "ckpt"), state)
    back = restore_state(p)
    np.testing.assert_array_equal(np.asarray(back["params"]),
                                  np.asarray(state["params"]))
    np.testing.assert_array_equal(np.asarray(back["cost"]),
                                  np.asarray(state["cost"]))


def test_surface_fit_roundtrip(tmp_path, rng):
    B, E, n = 2, 4, 10
    k = jnp.broadcast_to(jnp.linspace(-1, 1, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.2 + 0.05 * k**2
    fit = fit_surface(k, iv, T)
    path = save_surface_fit(str(tmp_path / "surf"), fit)
    fit2 = restore_surface_fit(path)
    assert fit2.method == "cubic_spline"
    kq = jnp.zeros((B, 3))
    Tq = jnp.broadcast_to(jnp.array([0.2, 0.5, 0.9]), (B, 3))
    np.testing.assert_array_equal(np.asarray(eval_surface(fit, kq, Tq)),
                                  np.asarray(eval_surface(fit2, kq, Tq)))
