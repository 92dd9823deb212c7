"""Batching: one kernel launch per batch, bit-exact per frame.

The fused kernel takes the batch as a grid axis (ops/fused.py): each
frame's programs read only that frame, so batching must be
bit-identical to running frames one at a time, and the differentiable
maps' gradient must match the per-frame gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.models import StereoMatcher


def _batch(B=3, H=24, W=40, seed=0):
    rng = np.random.default_rng(seed)
    cam = jnp.asarray(rng.uniform(size=(B, H, W)).astype(np.float32))
    proj = jnp.asarray(rng.uniform(size=(B, H, W)).astype(np.float32))
    return cam, proj


@pytest.mark.parametrize("k", [5, 7])
def test_stacked_batch_bit_exact(k):
    cam, proj = _batch()
    cfg = StereoConfig(kernel_size=k, num_disparities=6,
                       backend="pallas_interpret")
    model = StereoMatcher(cfg)
    got = model.disparity_maps(cam, proj)
    for i in range(cam.shape[0]):
        want = model.disparity_maps(cam[i:i + 1], proj[i:i + 1])
        for name in got._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)[i]),
                np.asarray(getattr(want, name)[0]),
                err_msg=f"frame {i} map {name}")


def test_stacked_batch_gradients_match_per_frame():
    cam, proj = _batch(B=2, H=16, W=32, seed=1)
    cfg = StereoConfig(kernel_size=5, num_disparities=6,
                       backend="pallas_interpret")
    model = StereoMatcher(cfg)
    target = jnp.zeros(cam.shape, jnp.float32)

    def loss_batched(c):
        m = model.trainable_disparity_maps(c, proj)
        return jnp.sum((m.soft_disparity - target) ** 2)

    def loss_frame(c1, i):
        m = model.trainable_disparity_maps(c1[None], proj[i:i + 1])
        return jnp.sum((m.soft_disparity[0] - target[i]) ** 2)

    g = jax.grad(loss_batched)(cam)
    for i in range(cam.shape[0]):
        gi = jax.grad(lambda c: loss_frame(c, i))(cam[i])
        # Batched XLA programs may accumulate in another order: fp32
        # reassociation noise only.
        np.testing.assert_allclose(np.asarray(g[i]), np.asarray(gi),
                                   rtol=1e-4, atol=1e-5)


def test_stacked_batch_xla_reference():
    """Batched fused kernel agrees with the XLA volume+head path."""
    cam, proj = _batch(B=2, H=20, W=48, seed=2)
    pall = StereoMatcher(StereoConfig(kernel_size=5, num_disparities=8,
                                      backend="pallas_interpret"))
    xla = StereoMatcher(StereoConfig(kernel_size=5, num_disparities=8,
                                     backend="xla"))
    got = pall.disparity_maps(cam, proj)
    want = xla(cam, proj)
    np.testing.assert_array_equal(np.asarray(got.disparity),
                                  np.asarray(want.disparity))
    np.testing.assert_allclose(np.asarray(got.soft_disparity),
                               np.asarray(want.soft_disparity),
                               rtol=1e-4, atol=1e-5)
