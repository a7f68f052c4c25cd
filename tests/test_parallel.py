"""Mesh/sharding tests on the 8-device virtual CPU mesh, plus the driver
dry-run entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from iv_engine.parallel.mesh import (
    make_mesh,
    pad_to_multiple,
    shard_batch,
    surface_batch_sharding,
)


def test_eight_virtual_devices():
    assert jax.device_count() == 8


def test_make_mesh_default():
    mesh = make_mesh()
    assert mesh.devices.shape == (8, 1)
    assert mesh.axis_names == ("data", "slice")


def test_make_mesh_2d():
    mesh = make_mesh((4, 2))
    assert mesh.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        make_mesh((3, 2))


def test_shard_batch_places_on_data_axis(rng):
    mesh = make_mesh((8, 1))
    x = jnp.array(rng.normal(size=(16, 5)))
    xs = shard_batch(mesh, x)
    assert xs.sharding.spec == P("data", None)
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(x))


@pytest.mark.slow
def test_sharded_surface_fit_matches_single_device(rng):
    """The headline parity requirement for sharding: identical numerics
    sharded vs unsharded."""
    from iv_engine.surface.surface import fit_eval_surface

    B, E, n = 16, 6, 12
    k = jnp.broadcast_to(jnp.linspace(-1, 1, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 2.0, E), (B, E))
    iv = 0.2 + 0.1 * k**2 + 0.01 * jnp.array(rng.normal(size=(B, 1, 1)))

    ref = fit_eval_surface(k, iv, T, n_grid=10)["w_grid"]

    mesh = make_mesh((8, 1))
    sh = surface_batch_sharding(mesh)
    ks = jax.device_put(k, sh)
    ivs = jax.device_put(iv, sh)
    Ts = jax.device_put(T, jax.NamedSharding(mesh, P("data", None)))
    out = jax.jit(
        lambda a, b, c: fit_eval_surface(a, b, c, n_grid=10)["w_grid"]
    )(ks, ivs, Ts)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-12)


@pytest.mark.slow
def test_graft_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape == (256, 30, 50)


@pytest.mark.slow
def test_dryrun_inprocess_8():
    """The dry-run step + parity assert on the conftest-provisioned mesh."""
    from iv_engine.parallel import dryrun

    dryrun.run(8)


@pytest.mark.slow
def test_dryrun_multichip_subprocess_ignores_ambient_platform(monkeypatch):
    """dryrun_multichip must self-provision: even with a hostile ambient
    env (GPU platform selected, wrong device count), the subprocess runs
    on an 8-device virtual CPU mesh (VERDICT r1 item 1)."""
    import __graft_entry__ as ge

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=1")
    ge.dryrun_multichip(8)


def test_pad_to_multiple():
    assert pad_to_multiple(17, 8) == 24
    assert pad_to_multiple(16, 8) == 16
    assert pad_to_multiple(1, 8) == 8


@pytest.mark.slow
def test_sharded_ah_fit_matches_single_device(rng):
    """Andreasen-Huge (scan over maturities, per-slice LM, PCR solves)
    is batch-pure like every other family: sharding the surface axis
    over the mesh must not change a single bit of the output."""
    from iv_engine.ops.andreasen_huge import fit_eval_ah_surface

    B, E, m = 16, 3, 9
    k = jnp.broadcast_to(jnp.linspace(-0.5, 0.5, m), (B, E, m))
    T = jnp.broadcast_to(jnp.array([0.2, 0.6, 1.1]), (B, E))
    iv = (0.25 + 0.1 * k * k
          + 0.02 * jnp.asarray(rng.normal(size=(B, 1, 1))))

    fit = lambda a, b, c: fit_eval_ah_surface(a, b, c, n_grid=65,
                                              n_iters=8)
    ref = fit(k, iv, T)

    mesh = make_mesh((8, 1))
    ks, ivs, Ts = shard_batch(mesh, k, iv, T)
    out = jax.jit(fit)(ks, ivs, Ts)
    # prices are the well-conditioned quantity: compare the fitted call
    # curves and flags tightly. w_grid passes through the Black
    # inversion, whose deep wings amplify last-ulp scheduling
    # differences (dC/dw -> 0 near intrinsic), so it gets a loose bound.
    np.testing.assert_allclose(np.asarray(out["fit"].c),
                               np.asarray(ref["fit"].c), atol=1e-12)
    for key in ("butterfly_ok", "calendar_ok"):
        np.testing.assert_array_equal(np.asarray(out[key]),
                                      np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(out["fit_rmse"]),
                               np.asarray(ref["fit_rmse"]), atol=1e-12)
    np.testing.assert_allclose(np.asarray(out["w_grid"]),
                               np.asarray(ref["w_grid"]), atol=1e-4)


@pytest.mark.slow
def test_sharded_essvi_fit_matches_single_device(rng):
    """eSSVI (one joint LM per surface) shards over the data axis like
    every other method: identical numerics sharded vs unsharded."""
    from iv_engine.ops.essvi import fit_essvi_batched

    B, E, n = 16, 4, 15
    k = jnp.broadcast_to(jnp.linspace(-1, 1, n), (B, E, n))
    theta = jnp.cumsum(
        jnp.array(rng.uniform(0.01, 0.05, (B, E))), axis=-1)
    w = theta[..., None] * (1.0 + 0.1 * k * k)

    ref = fit_essvi_batched(k, w, max_iters=16).params

    mesh = make_mesh((8, 1))
    sh = surface_batch_sharding(mesh)
    ks, ws = jax.device_put(k, sh), jax.device_put(w, sh)
    out = jax.jit(
        lambda a, b: fit_essvi_batched(a, b, max_iters=16).params
    )(ks, ws)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-12)


def test_pipeline_mesh_shapes(monkeypatch):
    """pipeline_mesh honors explicit shapes smaller than the host
    (devices subset + axis-name reconciliation), returns None for
    trivial meshes, raises on oversubscription, and refuses partial
    pins under jax.distributed (round-4 review findings)."""
    from iv_engine.parallel.mesh import pipeline_mesh

    assert pipeline_mesh(None) is not None          # 8 virtual devices
    assert pipeline_mesh((1,)) is None
    m = pipeline_mesh((4, 1))                       # subset + gen names
    assert dict(m.shape) == {"data": 4, "ax1": 1}
    m2 = pipeline_mesh((2, 2), ("data", "slice"))
    assert dict(m2.shape) == {"data": 2, "slice": 2}
    with pytest.raises(ValueError, match="visible"):
        pipeline_mesh((16,))
    # multi-host: partial pins are rejected, full covers allowed
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="single-host"):
        pipeline_mesh((4,))
    assert pipeline_mesh((8,)) is not None
