"""Production op (moments/box-filter formulation + closed-form VJP) vs the
golden oracle.

Covers the verify.py protocol: forward allclose and
VJP allclose with the all-ones cotangent (examples/verify.py:68) plus
random cotangents, in both all-pairs and banded modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.ops import golden, zncc


def _pair(H=14, W=18, seed=0):
    rng = np.random.default_rng(seed)
    cam = jnp.asarray(rng.uniform(size=(H, W)).astype(np.float32))
    proj = jnp.asarray(rng.uniform(size=(H, W)).astype(np.float32))
    return cam, proj


@pytest.mark.parametrize("k", [3, 5, 7])
def test_forward_allpairs_matches_golden(k):
    cam, proj = _pair()
    want = golden.zncc_cost_volume(cam, proj, None, k)
    got = zncc.stereo_matching(cam, proj, None, k)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k", [3, 5, 15])
@pytest.mark.parametrize("D", [0, 5])
def test_forward_banded_matches_golden(k, D):
    cam, proj = _pair(H=20, W=24, seed=1)
    want = golden.zncc_cost_volume(cam, proj, D, k)
    got = zncc.stereo_matching(cam, proj, D, k)
    assert got.shape == (20, 24, D + 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def _vjp_camera(fn, cam, proj, cotangent):
    out, pullback = jax.vjp(lambda c: fn(c), cam)
    del out
    return pullback(cotangent)[0]


@pytest.mark.parametrize("mode", ["allpairs", "banded"])
@pytest.mark.parametrize("cotangent", ["ones", "random"])
def test_camera_vjp_matches_golden(mode, cotangent):
    cam, proj = _pair(H=12, W=15, seed=2)
    k = 5
    D = None if mode == "allpairs" else 4
    L = 15 if mode == "allpairs" else 5
    if cotangent == "ones":
        # all-ones upstream grad: the reference's verify protocol
        # (examples/verify.py:68).
        g = jnp.ones((12, 15, L), jnp.float32)
    else:
        rng = np.random.default_rng(3)
        g = jnp.asarray(rng.normal(size=(12, 15, L)).astype(np.float32))

    want = golden.zncc_camera_grad(cam, proj, g, D, k)
    got = _vjp_camera(lambda c: zncc.stereo_matching(c, proj, D, k), cam, proj,
                      g)
    scale = float(jnp.max(jnp.abs(want))) + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale,
                               rtol=1e-3, atol=2e-4)


def test_projector_grad_is_zero_in_parity_op():
    # Reference parity: backward returns None for the projector
    # (custma/stereo_matching_wrapper.py:33) -> our op emits zeros.
    cam, proj = _pair(H=8, W=9, seed=4)
    out, pullback = jax.vjp(
        lambda c, p: zncc.stereo_matching(c, p, 3, 3), cam, proj)
    _, proj_grad = pullback(jnp.ones_like(out))
    assert float(jnp.max(jnp.abs(proj_grad))) == 0.0


@pytest.mark.parametrize("mode", ["allpairs", "banded"])
def test_proj_grad_extension_matches_golden(mode):
    cam, proj = _pair(H=10, W=12, seed=5)
    k = 3
    D = None if mode == "allpairs" else 4
    L = 12 if mode == "allpairs" else 5
    rng = np.random.default_rng(6)
    g = jnp.asarray(rng.normal(size=(10, 12, L)).astype(np.float32))

    want = golden.zncc_projector_grad(cam, proj, g, D, k)
    out, pullback = jax.vjp(
        lambda p: zncc.stereo_matching_with_proj_grad(cam, p, D, k), proj)
    got = pullback(g)[0]
    scale = float(jnp.max(jnp.abs(want))) + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale,
                               rtol=1e-3, atol=2e-4)


def test_jit_and_grad_compose():
    cam, proj = _pair(H=10, W=12, seed=7)

    @jax.jit
    def loss(c):
        cv = zncc.stereo_matching(c, proj, 4, 5)
        return jnp.sum(cv)

    val, grad = jax.value_and_grad(loss)(cam)
    assert np.isfinite(float(val))
    assert grad.shape == cam.shape
    assert np.all(np.isfinite(np.asarray(grad)))


def test_kernel_size_one():
    # degenerate 1x1 window: centered values are all zero, cost = eps/sqrt(eps)
    cam, proj = _pair(H=5, W=6, seed=8)
    cv = zncc.stereo_matching(cam, proj, 2, 1)
    expected = zncc.EPSILON / np.sqrt(zncc.EPSILON)
    np.testing.assert_allclose(np.asarray(cv), expected, rtol=1e-4)


def test_shape_validation():
    cam = jnp.zeros((4, 5))
    proj = jnp.zeros((4, 6))
    with pytest.raises(ValueError):
        zncc.stereo_matching(cam, proj, None, 3)


def test_grad_projector_flag_routes_model_layer():
    """StereoConfig.grad_projector wires the model to the both-grads op:
    the projector gradient is nonzero and matches the golden oracle."""
    from custereomatching_tpu.config import StereoConfig
    from custereomatching_tpu.models import StereoMatcher

    cam, proj = _pair(H=12, W=16, seed=9)
    k, D = 5, 6
    cfg = StereoConfig(kernel_size=k, num_disparities=D, grad_projector=True)
    model = StereoMatcher(cfg)

    def volume_sum(c, p):
        return jnp.sum(model.cost_volume(c[None], p[None]))

    gc, gp = jax.grad(volume_sum, argnums=(0, 1))(cam, proj)
    ones = jnp.ones((12, 16, D + 1), jnp.float32)
    want_p = golden.zncc_projector_grad(cam, proj, ones, D, k)
    want_c = golden.zncc_camera_grad(cam, proj, ones, D, k)
    assert float(jnp.max(jnp.abs(gp))) > 0
    np.testing.assert_allclose(np.asarray(gp), np.asarray(want_p),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(want_c),
                               rtol=1e-3, atol=2e-4)

    # The camera-only default is unchanged (parity): zero projector grad.
    model0 = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=D,
                                        backend="xla"))

    def volume_sum0(c, p):
        return jnp.sum(model0.cost_volume(c[None], p[None]))

    gp0 = jax.grad(volume_sum0, argnums=1)(cam, proj)
    assert float(jnp.max(jnp.abs(gp0))) == 0.0


def test_grad_projector_train_step_moves_loss():
    """disparity_loss honors grad_projector (no silent fused-path bypass)."""
    import optax

    from custereomatching_tpu.config import StereoConfig
    from custereomatching_tpu.models import StereoMatcher
    from custereomatching_tpu.models.optimize import disparity_loss

    cam, proj = _pair(H=12, W=16, seed=10)
    cfg = StereoConfig(kernel_size=5, num_disparities=6, grad_projector=True)
    model = StereoMatcher(cfg)
    target = jnp.zeros((1, 12, 16), jnp.float32)
    g = jax.grad(
        lambda p: disparity_loss(model, cam[None], p, target))(proj[None])
    assert float(jnp.max(jnp.abs(g))) > 0
    assert np.all(np.isfinite(np.asarray(g)))
