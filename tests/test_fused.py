"""The fused volume-free kernel (ops/fused.py) under the Pallas interpreter.

The kernel is compiled through Triton on a GPU; here it runs in
interpret mode and is checked against the XLA volume + head path and the
golden oracle: odd and non-power-of-two widths, D not a multiple of any
block, k from 1 to 15, both ends of β, threshold edges, batches, the
raw head state that pipeline stages merge, and the precision of the
window sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.ops import golden
from custereomatching_tpu.ops.disparity import extract_disparity
from custereomatching_tpu.ops.fused import (
    _tf32_parts,
    fused_disparity_maps,
    fused_head_state,
)
from custereomatching_tpu.ops.zncc import stereo_matching

EPS = 1e-8
TIE = 1e-5          # cost gap at which two disparities tie to rounding


def _pair(B, H, W, seed=0):
    rng = np.random.default_rng(seed)
    cam = rng.uniform(size=(B, H, W)).astype(np.float32)
    proj = rng.uniform(size=(B, H, W)).astype(np.float32)
    return jnp.asarray(cam), jnp.asarray(proj)


def _xla(cam, proj, D, k, beta=50.0, threshold=0.6):
    vols = [stereo_matching(c, p, D, k) for c, p in zip(cam, proj)]
    heads = [extract_disparity(v, num_disparities=D, threshold=threshold,
                               beta=beta) for v in vols]
    return np.stack([np.asarray(v) for v in vols]), heads


def _assert_maps_match(got, vols, heads, soft_atol=1e-4):
    for b, want in enumerate(heads):
        gd = np.asarray(got.disparity[b])
        wd = np.asarray(want.disparity)
        diff = gd != wd
        if diff.any():
            # Only near-ties may resolve differently.
            v = vols[b]
            a = np.take_along_axis(v, gd.astype(int)[..., None], -1)[..., 0]
            w = np.take_along_axis(v, wd.astype(int)[..., None], -1)[..., 0]
            assert np.abs(a - w)[diff].max() <= TIE
        np.testing.assert_allclose(np.asarray(got.confidence[b]),
                                   np.asarray(want.confidence), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(got.mask[b]),
                                      np.asarray(want.mask))
        # Online rescaling rounds t and s relative to their size: the
        # soft disparity agrees to ~1e-5 relative, plus an absolute floor.
        np.testing.assert_allclose(np.asarray(got.soft_disparity[b]),
                                   np.asarray(want.soft_disparity),
                                   rtol=2e-5, atol=soft_atol)


@pytest.mark.parametrize("shape", [
    # (B, H, W, D, k)
    (1, 24, 150, 10, 5),     # several row and column tiles, odd sizes
    (1, 17, 100, 3, 3),      # tiny D, H not a multiple of the row block
    (1, 12, 260, 140, 7),    # D wider than a column tile
    (1, 9, 40, 0, 5),        # D=0: the self-correlation band only
    (1, 16, 100, 37, 7),     # D not a multiple of anything
    (1, 13, 33, 5, 15),      # reference window, image barely wider
    (1, 40, 96, 12, 15),     # reference window, several row tiles
    (1, 31, 97, 24, 9),      # prime width
    (2, 20, 45, 9, 5),       # batch of two
    (3, 11, 64, 6, 3),       # batch of three, power-of-two width
    (1, 5, 7, 6, 3),         # image smaller than one tile
    (1, 33, 129, 16, 11),    # W just over a power of two
])
def test_fused_matches_xla_path(shape):
    B, H, W, D, k = shape
    cam, proj = _pair(B, H, W, seed=sum(shape))
    got = fused_disparity_maps(cam, proj, D, k, EPS, 50.0, 0.6, True)
    vols, heads = _xla(cam, proj, D, k)
    _assert_maps_match(got, vols, heads)


@pytest.mark.parametrize("shape", [
    (16, 24, 5, 3), (24, 60, 10, 5), (13, 40, 7, 7), (9, 50, 12, 15),
    (20, 33, 0, 9),
])
def test_fused_matches_golden(shape):
    """Confidence and arg-max vs the patch-based oracle volume."""
    H, W, D, k = shape
    cam, proj = _pair(1, H, W, seed=H * W)
    st = fused_head_state(cam, proj, D, k, EPS, 50.0, True)
    vol = np.asarray(golden.zncc_cost_volume(cam[0], proj[0], D, k))
    np.testing.assert_allclose(np.asarray(st.conf[0]), vol.max(-1),
                               rtol=5e-4, atol=5e-5)
    am = np.asarray(st.am[0]).astype(int)
    best = np.take_along_axis(vol, am[..., None], -1)[..., 0]
    assert np.abs(best - vol.max(-1)).max() <= 5e-5


def test_fused_k1_has_no_confident_pixel():
    """A 1×1 window has zero centred moments: every cost is the ε ratio
    (~1e-4), nothing passes the threshold, all maps are masked to 0."""
    cam, proj = _pair(1, 10, 40, seed=3)
    got = fused_disparity_maps(cam, proj, 6, 1, EPS, 50.0, 0.6, True)
    assert float(jnp.abs(got.confidence).max()) < 1e-2
    for m in (got.mask, got.disparity, got.soft_disparity):
        assert float(jnp.abs(m).max()) == 0.0


@pytest.mark.parametrize("beta", [0.5, 5.0, 50.0, 500.0, 5000.0])
def test_fused_beta_range(beta):
    """The online softmax is max-normalised: no overflow at large β, and
    the soft-argmax follows the XLA head at both ends."""
    cam, proj = _pair(1, 18, 70, seed=11)
    D, k = 20, 7
    got = fused_disparity_maps(cam, proj, D, k, EPS, beta, 0.6, True)
    vols, heads = _xla(cam, proj, D, k, beta=beta)
    assert np.isfinite(np.asarray(got.soft_disparity)).all()
    # Soft disparity sensitivity grows with β (a cost rounding of δ moves
    # weights by ~β·δ).
    _assert_maps_match(got, vols, heads, soft_atol=1e-4 * max(beta / 50, 1))


@pytest.mark.parametrize("threshold", [-2.0, -0.5, 0.0, 0.3, 0.6, 0.9, 1.5])
def test_fused_threshold_edges(threshold):
    cam, proj = _pair(1, 16, 48, seed=5)
    D, k = 8, 5
    got = fused_disparity_maps(cam, proj, D, k, EPS, 50.0, threshold, True)
    st = fused_head_state(cam, proj, D, k, EPS, 50.0, True)
    mask = (np.asarray(st.conf) > threshold).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(got.mask), mask)
    if threshold < -1.0:
        assert mask.all()            # |cost| ≤ 1 + ε
    if threshold > 1.0:
        assert not mask.any()
    vols, heads = _xla(cam, proj, D, k, threshold=threshold)
    _assert_maps_match(got, vols, heads)


@pytest.mark.parametrize("B", [2, 3, 4])
def test_fused_batch_equals_per_frame(B):
    """Frames are a grid axis of one launch: bit-identical per frame."""
    cam, proj = _pair(B, 19, 53, seed=B)
    got = fused_head_state(cam, proj, 9, 5, EPS, 50.0, True)
    for b in range(B):
        one = fused_head_state(cam[b:b + 1], proj[b:b + 1], 9, 5, EPS, 50.0,
                               True)
        for name in got._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)[b]),
                np.asarray(getattr(one, name)[0]), err_msg=name)


@pytest.mark.parametrize("d_offset", [0, 3, 6, 9])
def test_fused_head_state_matches_xla_chunk(d_offset):
    """The raw state (am, β·conf, s, t) of a stage's chunk equals the XLA
    chunk state that merge_states combines."""
    from custereomatching_tpu.config import StereoConfig
    from custereomatching_tpu.parallel.pipeline import chunk_state

    cam, proj = _pair(1, 16, 40, seed=2)
    kw = dict(kernel_size=5, num_disparities=11)
    chunk = 3
    got = chunk_state(cam[0], proj[0], d_offset, chunk,
                      StereoConfig(backend="pallas_interpret", **kw))
    want = chunk_state(cam[0], proj[0], d_offset, chunk,
                       StereoConfig(backend="xla", **kw))
    np.testing.assert_array_equal(np.asarray(got.am), np.asarray(want.am))
    for name in ("m", "s", "t"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape", [
    (24, 150, 10, 5), (40, 96, 12, 15), (31, 97, 24, 9), (16, 100, 37, 7),
])
def test_fused_tf32_precision_fails_parity(shape):
    """precision="default" sums the windows in one TF32 pass: the
    confidence leaves the parity tolerance (1e-5) that the float32 path
    meets, yet stays within TF32's reach of the XLA path."""
    H, W, D, k = shape
    cam, proj = _pair(1, H, W, seed=H + W)
    vols, heads = _xla(cam, proj, D, k)
    got = fused_disparity_maps(cam, proj, D, k, EPS, 50.0, 0.6, True,
                               "default")
    err = np.abs(np.asarray(got.confidence[0])
                 - np.asarray(heads[0].confidence)).max()
    assert 1e-5 < err <= 1e-2
    with pytest.raises(AssertionError):
        _assert_maps_match(got, vols, heads)


@pytest.mark.parametrize("bad", [
    dict(cam=(1, 8, 16), proj=(1, 8, 17), k=3),   # shape mismatch
    dict(cam=(8, 16), proj=(8, 16), k=3),          # unbatched
    dict(cam=(1, 8, 16), proj=(1, 8, 16), k=4),   # even window
    dict(cam=(1, 8, 16), proj=(1, 8, 16), k=-1),  # negative window
    dict(cam=(1, 8, 16), proj=(1, 8, 16), k=3, precision="high"),
])
def test_fused_rejects_bad_inputs(bad):
    cam = jnp.zeros(bad["cam"], jnp.float32)
    proj = jnp.zeros(bad["proj"], jnp.float32)
    with pytest.raises(ValueError):
        fused_head_state(cam, proj, 4, bad["k"], EPS, 50.0, True,
                         bad.get("precision", "highest"))


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 3), (2, 3), (0, 1)])
def test_tf32_parts(seed, n):
    """Every part is exact in TF32 (low 13 mantissa bits zero); three
    parts sum to x exactly, one part is x to TF32's 2⁻¹¹ relative."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    parts = [np.asarray(p) for p in _tf32_parts(jnp.asarray(x), n)]
    for part in parts:
        assert not (part.view(np.uint32) & 0x1FFF).any()
    err = np.abs(x.astype(np.float64)
                 - sum(p.astype(np.float64) for p in parts))
    bound = 0.0 if n == 3 else 2.0 ** -11
    assert (err <= bound * np.abs(x.astype(np.float64))).all()
