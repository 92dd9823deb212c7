"""Sharded-pipeline parity tests on a virtual 8-device CPU mesh.

A distributed "fake backend" (survey §4): conftest.py forces 8 virtual
CPU devices, and these tests assert that the
mesh-sharded cost volume — halo exchange over 'space', batch over 'data'
— is numerically identical to the single-device op, including the
zero-pad semantics at true image borders that the halo exchange must
preserve (reference: custma/src/stereo_matching_kernel.cu:6-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.config import MeshConfig, StereoConfig
from custereomatching_tpu.models import StereoMatcher, optimize_camera
from custereomatching_tpu.parallel import (
    halo_exchange,
    make_mesh,
    shard_batch,
    sharded_cost_volume,
)

jax.config.update("jax_enable_x64", False)


def _random_batch(rng, B, H, W):
    cam = rng.random((B, H, W), dtype=np.float32)
    proj = rng.random((B, H, W), dtype=np.float32)
    return jnp.asarray(cam), jnp.asarray(proj)


def test_halo_exchange_matches_global_rows():
    """Halo-extended shards reproduce global rows; borders get zeros."""
    mesh = make_mesh(MeshConfig(data=1, space=4))
    H, W, halo = 32, 16, 3
    x = jnp.arange(H * W, dtype=jnp.float32).reshape(1, H, W)

    fn = jax.shard_map(
        lambda b: halo_exchange(b, halo, "space", axis=1),
        mesh=mesh,
        in_specs=jax.sharding.PartitionSpec("data", "space", None),
        out_specs=jax.sharding.PartitionSpec("data", "space", None),
    )
    out = np.asarray(fn(x))  # [1, 4*(8+2*halo), W] stacked shard blocks
    blocks = out.reshape(4, 8 + 2 * halo, W)
    xg = np.asarray(x[0])
    zeros = np.zeros((halo, W), np.float32)
    padded = np.concatenate([zeros, xg, zeros], axis=0)
    for s in range(4):
        want = padded[s * 8: s * 8 + 8 + 2 * halo]
        np.testing.assert_array_equal(blocks[s], want)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 1), (1, 4), (2, 4)])
@pytest.mark.parametrize("banded", [True, False])
def test_sharded_cost_volume_parity(mesh_shape, banded):
    """Sharded volume == single-device volume for every mesh layout."""
    rng = np.random.default_rng(0)
    B, H, W = 2, 24, 20
    cfg = StereoConfig(kernel_size=5, num_disparities=6 if banded else None)
    cam, proj = _random_batch(rng, B, H, W)

    model = StereoMatcher(cfg)
    want = np.asarray(model.cost_volume(cam, proj))

    mesh = make_mesh(MeshConfig(data=mesh_shape[0], space=mesh_shape[1]))
    cam_s, proj_s = shard_batch((cam, proj), mesh)
    got = np.asarray(sharded_cost_volume(cam_s, proj_s, cfg, mesh))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_gradient_parity():
    """Camera gradient through the sharded path (halo transpose included)
    matches the single-device analytic VJP."""
    rng = np.random.default_rng(1)
    B, H, W = 1, 16, 12
    cfg = StereoConfig(kernel_size=3, num_disparities=4)
    cam, proj = _random_batch(rng, B, H, W)
    model = StereoMatcher(cfg)

    def loss_single(c):
        return jnp.sum(model.cost_volume(c, proj) ** 2)

    want = np.asarray(jax.grad(loss_single)(cam))

    mesh = make_mesh(MeshConfig(data=1, space=4))
    cam_s, proj_s = shard_batch((cam, proj), mesh)

    def loss_sharded(c):
        return jnp.sum(sharded_cost_volume(c, proj_s, cfg, mesh) ** 2)

    got = np.asarray(jax.grad(loss_sharded)(cam_s))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_halo_larger_than_shard_raises():
    cfg = StereoConfig(kernel_size=15, num_disparities=4)  # halo 7 > 16/4
    mesh = make_mesh(MeshConfig(data=1, space=4))
    cam = jnp.zeros((1, 16, 12))
    with pytest.raises(Exception):
        jax.block_until_ready(sharded_cost_volume(cam, cam, cfg, mesh))


def test_optimize_camera_reduces_loss():
    """End-to-end training: optimizing the camera image lowers the
    disparity loss (the reference's intended differentiable use,
    custma/stereo_matching_wrapper.py:33)."""
    rng = np.random.default_rng(2)
    B, H, W, D = 1, 16, 24, 6
    cfg = StereoConfig(kernel_size=5, num_disparities=D)
    model = StereoMatcher(cfg)

    proj = jnp.asarray(rng.random((B, H, W), dtype=np.float32))
    # Target camera = projector shifted right by 3 → true disparity 3.
    true_cam = jnp.roll(proj, 3, axis=2)
    target = np.asarray(
        model(true_cam, proj).soft_disparity)
    cam0 = true_cam + 0.1 * jnp.asarray(
        rng.standard_normal((B, H, W)).astype(np.float32))

    _, losses = optimize_camera(model, cam0, proj, jnp.asarray(target),
                                learning_rate=1e-3, num_steps=30)
    assert float(losses[-1]) < float(losses[0])


def test_sharded_pallas_cost_volume_parity():
    """A "pallas_interpret" config inside shard_map builds the XLA volume
    (only disparity maps use the kernel) and matches one device."""
    rng = np.random.default_rng(5)
    B, H, W, D, K = 2, 24, 40, 6, 5
    cam, proj = _random_batch(rng, B, H, W)
    cfg_pl = StereoConfig(kernel_size=K, num_disparities=D,
                          backend="pallas_interpret")
    want = np.asarray(StereoMatcher(
        StereoConfig(kernel_size=K, num_disparities=D,
                     backend="xla")).cost_volume(cam, proj))
    mesh = make_mesh(MeshConfig(data=2, space=4))
    cam_s, proj_s = shard_batch((cam, proj), mesh)
    got = np.asarray(sharded_cost_volume(cam_s, proj_s, cfg_pl, mesh))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_fused_pipeline_parity_and_grad():
    """Fused volume-free kernel under (data, space) sharding: outputs
    match the single-device XLA head; the differentiable maps' gradients
    flow back through the transposed halo exchange and the volume VJP."""
    from custereomatching_tpu.parallel import sharded_disparity_maps

    rng = np.random.default_rng(6)
    B, H, W, D, K = 2, 32, 48, 6, 5
    cam, proj = _random_batch(rng, B, H, W)
    cfg = StereoConfig(kernel_size=K, num_disparities=D,
                       backend="pallas_interpret")
    mesh = make_mesh(MeshConfig(data=2, space=4))
    cam_s, proj_s = shard_batch((cam, proj), mesh)

    model_xla = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D,
                                           backend="xla"))
    want = model_xla(cam, proj)
    got = sharded_disparity_maps(cam_s, proj_s, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(got.disparity),
                                  np.asarray(want.disparity))
    np.testing.assert_allclose(np.asarray(got.soft_disparity),
                               np.asarray(want.soft_disparity),
                               rtol=1e-3, atol=1e-4)

    target = jnp.zeros((B, H, W))

    def loss_sh(c):
        r = sharded_disparity_maps(c, proj_s, cfg, mesh, trainable=True)
        return jnp.mean((r.soft_disparity - target) ** 2)

    def loss_x(c):
        out = model_xla(c, proj)
        return jnp.mean((out.soft_disparity - target) ** 2)

    g1 = np.asarray(jax.grad(loss_sh)(cam_s))
    g2 = np.asarray(jax.grad(loss_x)(cam))
    np.testing.assert_allclose(g1, g2, rtol=1e-3, atol=1e-6)


def test_sharded_train_step_runs():
    """One sharded train step executes and returns finite metrics."""
    import optax
    from custereomatching_tpu.models import init_state, make_train_step

    rng = np.random.default_rng(3)
    B, H, W, D = 2, 16, 20, 4
    cfg = StereoConfig(kernel_size=3, num_disparities=D)
    model = StereoMatcher(cfg)
    mesh = make_mesh(MeshConfig(data=2, space=4))

    cam, proj = _random_batch(rng, B, H, W)
    target = jnp.zeros((B, H, W), jnp.float32)
    cam, proj, target = shard_batch((cam, proj, target), mesh)

    optimizer = optax.adam(1e-2)
    state = init_state(cam, optimizer)
    step = make_train_step(model, optimizer, mesh)
    state, metrics = step(state, proj, target)
    assert np.isfinite(float(metrics.loss))
    assert np.isfinite(float(metrics.grad_norm))
    assert int(state.step) == 1
