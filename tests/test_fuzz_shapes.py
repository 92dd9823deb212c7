"""Randomized-shape conformance sweep: every path vs the oracle.

The parametrized tests elsewhere pin a handful of shapes; this sweep
draws random (H, W, D, k) combinations each run from a seeded
space — odd sizes, tiny margins, D≈W, k≈min(H,W) — and checks the
XLA moments op (forward, camera and projector gradients) against the
float64 brute-force oracle and the fused kernel (interpret mode)
against the XLA volume + head.  Shapes here have caught
alignment/margin bugs the fixed shapes missed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.ops import golden, zncc
from custereomatching_tpu.ops.fused import (
    fused_disparity_maps,
    fused_head_state,
)
from tests.np_oracle import zncc_brute

RNG = np.random.default_rng(20260816)
CASES = []
for _ in range(6):
    H = int(RNG.integers(9, 40))
    W = int(RNG.integers(17, 70))
    # k=1 is excluded: with a 1x1 window the true moments are exactly
    # zero and the eps-regularized cost is pure fp-noise (FMA fusion of
    # sxy - mux*sy leaves +-1 ulp where the math cancels); the reference's
    # two-pass CUDA has the same degeneracy.  k=1 values are pinned by
    # test_kernel_size_one on the XLA path.
    k = int(RNG.choice([3, 5, 7, 9, 15]))
    D = int(RNG.integers(0, min(W - 1, 24)))
    CASES.append((H, W, D, k))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backends_match_float64_oracle(case):
    H, W, D, k = case
    rng = np.random.default_rng(hash(case) % (2**32))
    cam = rng.uniform(size=(H, W)).astype(np.float32)
    proj = rng.uniform(size=(H, W)).astype(np.float32)
    want = zncc_brute(cam, proj, k, D)

    got_xla = np.asarray(zncc.stereo_matching(jnp.asarray(cam),
                                              jnp.asarray(proj), D, k))
    np.testing.assert_allclose(got_xla, want, rtol=5e-4, atol=5e-5,
                               err_msg=f"xla {case}")

    # Gradient with a random cotangent, vs jax.grad of the golden oracle.
    g = rng.normal(size=want.shape).astype(np.float32)
    want_grad = np.asarray(golden.zncc_camera_grad(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g), D, k))

    def loss(fn, c):
        return jnp.sum(fn(c) * jnp.asarray(g))

    got_grad = np.asarray(jax.grad(lambda c: loss(
        lambda cc: zncc.stereo_matching(cc, jnp.asarray(proj), D, k),
        c))(jnp.asarray(cam)))
    scale = np.abs(want_grad).max() + 1e-6
    np.testing.assert_allclose(got_grad / scale, want_grad / scale,
                               rtol=1e-3, atol=5e-5,
                               err_msg=f"xla grad {case}")

    # Both-gradients variant (the projector half the reference never
    # wrote) vs golden autodiff.
    gcb, gpb = jax.grad(
        lambda c, p: loss(
            lambda cc: zncc.stereo_matching_with_proj_grad(cc, p, D, k), c),
        argnums=(0, 1))(jnp.asarray(cam), jnp.asarray(proj))
    np.testing.assert_allclose(np.asarray(gcb) / scale, want_grad / scale,
                               rtol=1e-3, atol=5e-5,
                               err_msg=f"both-grads cam {case}")
    want_pgrad = np.asarray(golden.zncc_projector_grad(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g), D, k))
    pscale = np.abs(want_pgrad).max() + 1e-6
    np.testing.assert_allclose(np.asarray(gpb) / pscale,
                               want_pgrad / pscale,
                               rtol=1e-3, atol=5e-5,
                               err_msg=f"both-grads proj {case}")


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_fused_pipeline_random_shapes(case):
    H, W, D, k = case
    rng = np.random.default_rng(hash(case) % (2**31))
    cam = jnp.asarray(rng.uniform(size=(H, W)).astype(np.float32))
    proj = jnp.asarray(rng.uniform(size=(H, W)).astype(np.float32))

    from custereomatching_tpu.ops.disparity import extract_disparity

    cv = zncc.stereo_matching(cam, proj, D, k)
    want = extract_disparity(cv, num_disparities=D, threshold=0.6)
    got = jax.tree_util.tree_map(
        lambda x: x[0], fused_disparity_maps(
            cam[None], proj[None], D, k, 1e-8, 50.0, 0.6, True))
    st = fused_head_state(cam[None], proj[None], D, k, 1e-8, 50.0, True)
    np.testing.assert_array_equal(np.asarray(st.am[0]) * np.asarray(got.mask),
                                  np.asarray(got.disparity))
    np.testing.assert_array_equal(np.asarray(got.disparity),
                                  np.asarray(want.disparity),
                                  err_msg=f"hard {case}")
    np.testing.assert_allclose(np.asarray(got.soft_disparity),
                               np.asarray(want.soft_disparity),
                               rtol=1e-3, atol=1e-3,
                               err_msg=f"soft {case}")


ALLPAIRS_CASES = [(11, 26, 5), (17, 33, 7), (9, 40, 15)]


@pytest.mark.parametrize("case", ALLPAIRS_CASES, ids=str)
def test_allpairs_random_shapes(case):
    """All-pairs mode (reference's actual behavior) vs the brute oracle,
    forward and gradient."""
    H, W, k = case
    rng = np.random.default_rng(hash(case) % (2**32))
    cam = rng.uniform(size=(H, W)).astype(np.float32)
    proj = rng.uniform(size=(H, W)).astype(np.float32)
    want = zncc_brute(cam, proj, k, None)
    got = np.asarray(zncc.stereo_matching(jnp.asarray(cam),
                                          jnp.asarray(proj), None, k))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)

    g = rng.normal(size=want.shape).astype(np.float32)
    want_grad = np.asarray(golden.zncc_camera_grad(
        jnp.asarray(cam), jnp.asarray(proj), jnp.asarray(g), None, k))
    got_grad = np.asarray(jax.grad(lambda c: jnp.sum(
        zncc.stereo_matching(c, jnp.asarray(proj), None, k)
        * jnp.asarray(g)))(jnp.asarray(cam)))
    scale = np.abs(want_grad).max() + 1e-6
    np.testing.assert_allclose(got_grad / scale, want_grad / scale,
                               rtol=1e-3, atol=5e-5)
