"""Coarse-to-fine pyramid stereo matcher.

A second model family beyond the reference's single flat op: match at
low resolution over the full disparity range, then refine at full
resolution over a narrow residual band around the upsampled coarse
estimate.  For KITTI-scale D this cuts the matching work by roughly
``downsample²`` on the coarse level and ``(2·residual+1)/(D+1)`` on the
fine level — an order of magnitude at D=192 — while reusing
:meth:`StereoMatcher.disparity_maps` unchanged at both levels (the
residual search is just a banded match against a *per-pixel warped*
projector).

Approximation note: the fine-level ZNCC windows straddle pixels with
different warp shifts, so near disparity discontinuities the residual
match sees slightly distorted projector patches — the standard
coarse-to-fine trade.  The confidence mask catches those pixels, and on
smooth scenes the pyramid matches direct search to sub-pixel EPE
(tests/test_pyramid.py).

No reference counterpart (the reference computes the full volume always,
with its banded variant abandoned in comments —
custma/src/stereo_matching_kernel.cu:14,192-198).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.models.stereo import StereoMatcher
from custereomatching_tpu.ops.disparity import PipelineMaps


def _avg_pool(img: jax.Array, f: int) -> jax.Array:
    """f×f mean pooling (pads with edge rows/cols to a multiple of f)."""
    H, W = img.shape
    ph, pw = (-H) % f, (-W) % f
    img = jnp.pad(img, ((0, ph), (0, pw)), mode="edge")
    Hp, Wp = img.shape
    return img.reshape(Hp // f, f, Wp // f, f).mean(axis=(1, 3))


def _upsample(x: jax.Array, f: int, H: int, W: int) -> jax.Array:
    """Nearest-neighbor f× upsampling, cropped to [H, W]."""
    up = jnp.repeat(jnp.repeat(x, f, axis=0), f, axis=1)
    return up[:H, :W]


def _select_shifted(src: jax.Array, k_map: jax.Array, lo: int,
                    hi: int) -> jax.Array:
    """``out[y, x] = src[y, x - k_map[y, x]]`` for integer ``k_map`` values
    in ``[lo, hi]``, zero where the source column is out of view.

    Evaluated as a where-select over the ``hi - lo + 1`` statically
    shifted copies of ``src`` — O((hi-lo)·H·W) elementwise ops that XLA
    fuses into one pass.  Whether a gather is faster on a GPU is not
    measured yet.
    """
    H, W = src.shape
    pl_, pr = max(hi, 0), max(-lo, 0)
    padded = jnp.pad(src, ((0, 0), (pl_, pr)))
    out = jnp.zeros_like(src)
    k_map = k_map.astype(jnp.int32)
    for k in range(lo, hi + 1):
        shifted = lax.slice_in_dim(padded, pl_ - k, pl_ - k + W, axis=1)
        out = jnp.where(k_map == k, shifted, out)
    return out


def _warp_projector(projector: jax.Array, shift: jax.Array, lo: int,
                    hi: int) -> jax.Array:
    """``out[y, x] = projector[y, x - shift[y, x]]`` with zeros where the
    source column is out of view (the reference's zero-pad convention,
    custma/src/stereo_matching_kernel.cu:6-12).  ``shift`` must be
    integer-valued within ``[lo, hi]``."""
    return _select_shifted(projector, shift, lo, hi)


@dataclasses.dataclass(frozen=True)
class PyramidStereoMatcher:
    """Two-level coarse-to-fine matcher built on :class:`StereoMatcher`.

    Attributes:
      config: full-resolution configuration (``num_disparities`` is the
        full search range D; must be banded).
      downsample: coarse-level reduction factor f (coarse range ≈ D/f at
        1/f² the pixels).
      residual: half-width r of the fine-level residual band (searches
        ``[-r, +r]`` around the upsampled coarse estimate).
    """

    config: StereoConfig = StereoConfig(num_disparities=192)
    downsample: int = 4
    residual: int = 12

    def __post_init__(self):
        if self.config.num_disparities is None:
            raise ValueError("pyramid matching requires banded mode")

    @functools.cached_property
    def _coarse(self) -> StereoMatcher:
        c = self.config
        d_coarse = -(-c.num_disparities // self.downsample)
        # threshold −1 → all-ones mask: the warp needs the raw soft
        # estimate everywhere; zeroed-out low-confidence pixels would
        # center the fine band at disparity ≈ 0 and lose those pixels.
        return StereoMatcher(dataclasses.replace(
            c, num_disparities=d_coarse, cost_threshold=-1.0))

    @functools.cached_property
    def _fine(self) -> StereoMatcher:
        return StereoMatcher(dataclasses.replace(
            self.config, num_disparities=2 * self.residual))

    def _single(self, camera: jax.Array, projector: jax.Array
                ) -> PipelineMaps:
        H, W = camera.shape
        f, r = self.downsample, self.residual

        cam_c = _avg_pool(camera, f)
        proj_c = _avg_pool(projector, f)
        coarse = self._coarse.disparity_maps(cam_c[None], proj_c[None])
        d_up = _upsample(coarse.soft_disparity[0], f, H, W) * f

        # Warp so the fine search band [0, 2r] is centered on the coarse
        # estimate: shift = round(d_up) - r, clamped to the physical range.
        D = self.config.num_disparities
        shift = jnp.clip(jnp.round(d_up) - r, -r, D)
        proj_w = _warp_projector(projector, shift, -r, D)
        fine = self._fine.disparity_maps(camera[None], proj_w[None])

        # Compose with the shift WHERE THE MATCHER SAMPLED IT: band index
        # d at pixel x read proj_w[x − d] = proj[x − d − shift(x − d)], so
        # the total disparity is d + shift(x − d).  Using shift(x) instead
        # is off by one for ~half the pixels on sloped surfaces (round()
        # flips across the window).
        def compose(d_res):
            shift_at = _select_shifted(shift, jnp.round(d_res), 0, 2 * r)
            return (shift_at + d_res).astype(camera.dtype)

        hard = compose(fine.disparity[0]) * fine.mask[0]
        soft = compose(fine.soft_disparity[0]) * fine.mask[0]
        # Negative disparities are physically invalid (reference searches
        # only leftward); clamp and drop confidence there.
        neg = jnp.logical_or(hard < 0, soft < 0)
        mask = jnp.where(neg, 0.0, fine.mask[0])
        return PipelineMaps(disparity=jnp.maximum(hard, 0.0) * mask,
                            soft_disparity=jnp.maximum(soft, 0.0) * mask,
                            mask=mask, confidence=fine.confidence[0])

    def __call__(self, camera: jax.Array, projector: jax.Array
                 ) -> PipelineMaps:
        """Batched ``[B, H, W]`` pair → disparity maps."""
        return jax.lax.map(lambda cp: self._single(cp[0], cp[1]),
                           (camera, projector))
