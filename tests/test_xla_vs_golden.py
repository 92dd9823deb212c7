"""The XLA volume op and its closed-form VJPs vs the golden oracle, at the
shapes that pinned the earlier hand-written volume kernels: several row
and disparity tiles, H not a multiple of a block, D wider than a tile,
D=0, widths on either side of a power of two.  On a GPU these XLA
programs are the only volume and gradient path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.ops import golden, zncc


def _pair(H, W, seed):
    rng = np.random.default_rng(seed)
    cam = jnp.asarray(rng.uniform(size=(H, W)).astype(np.float32))
    proj = jnp.asarray(rng.uniform(size=(H, W)).astype(np.float32))
    return cam, proj


def _scaled_close(got, want, rtol=1e-3, atol=2e-4):
    scale = float(jnp.max(jnp.abs(want))) + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, rtol=rtol, atol=atol)


BANDED = [
    # (H, W, D, k)
    (24, 150, 10, 5),
    (17, 100, 3, 3),
    (12, 260, 140, 7),
    (9, 40, 0, 5),
    (16, 100, 37, 7),
]


@pytest.mark.parametrize("shape", BANDED)
def test_banded_forward_matches_golden(shape):
    H, W, D, k = shape
    cam, proj = _pair(H, W, seed=sum(shape))
    got = zncc.stereo_matching(cam, proj, D, k)
    want = golden.zncc_cost_volume(cam, proj, D, k)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("shape", [(24, 150, 10, 5), (16, 100, 37, 7),
                                   (16, 24, 5, 3), (40, 96, 12, 15)])
def test_banded_camera_vjp_matches_golden(shape):
    H, W, D, k = shape
    cam, proj = _pair(H, W, seed=H + W)
    g = jax.random.normal(jax.random.PRNGKey(H), (H, W, D + 1), jnp.float32)
    got = jax.grad(lambda c: jnp.sum(zncc.stereo_matching(c, proj, D, k)
                                     * g))(cam)
    _scaled_close(got, golden.zncc_camera_grad(cam, proj, g, D, k))


@pytest.mark.parametrize("shape", [(16, 24, 5, 3), (24, 150, 10, 5),
                                   (40, 96, 12, 15)])
def test_banded_projector_vjp_matches_golden(shape):
    H, W, D, k = shape
    cam, proj = _pair(H, W, seed=H * 3 + W)
    g = jax.random.normal(jax.random.PRNGKey(W), (H, W, D + 1), jnp.float32)
    gc, gp = jax.grad(lambda c, p: jnp.sum(
        zncc.stereo_matching_with_proj_grad(c, p, D, k) * g),
        argnums=(0, 1))(cam, proj)
    _scaled_close(gc, golden.zncc_camera_grad(cam, proj, g, D, k))
    _scaled_close(gp, golden.zncc_projector_grad(cam, proj, g, D, k))


ALLPAIRS = [
    # (H, W, k)
    (24, 60, 5),
    (16, 150, 15),
    (13, 40, 7),
    (9, 129, 3),
]


@pytest.mark.parametrize("shape", ALLPAIRS)
def test_allpairs_forward_matches_golden(shape):
    H, W, k = shape
    cam, proj = _pair(H, W, seed=W)
    got = zncc.stereo_matching(cam, proj, None, k)
    want = golden.zncc_cost_volume(cam, proj, None, k)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("shape", ALLPAIRS)
def test_allpairs_camera_vjp_matches_golden(shape):
    H, W, k = shape
    cam, proj = _pair(H, W, seed=H)
    g = jax.random.normal(jax.random.PRNGKey(k), (H, W, W), jnp.float32)
    got = jax.grad(lambda c: jnp.sum(zncc.stereo_matching(c, proj, None, k)
                                     * g))(cam)
    _scaled_close(got, golden.zncc_camera_grad(cam, proj, g, None, k))
