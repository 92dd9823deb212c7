"""Disparity extraction from ZNCC cost volumes.

In the reference this pipeline only exists as example-script code — partly
commented out: confidence mask (examples/verify.py:72-74, test.py:71-73),
hard argmax correspondence (test.py:78), soft-argmax (verify.py:31-39,
invoked only in the commented test.py:79), and
``disparity = template − correspondence`` masked by confidence
(test.py:80-86).  Here it is a first-class, differentiable, jit-friendly
API.

Conventions:
  * All-pairs volumes ``[H, W, W]``: the last axis is the absolute
    projector column, so ``disparity = w − correspondence`` (the meshgrid
    "template" of test.py:80-83).
  * Banded volumes ``[H, W, D+1]``: the band index *is* the disparity.
  * ``mask = max_d cost > threshold`` (verify.py:74); masked pixels get
    disparity 0, matching ``torch.mul(disparity, cost_volume_mask)``
    (test.py:84).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class DisparityResult(NamedTuple):
    """Outputs of the disparity head.

    Attributes:
      disparity: ``[H, W]`` hard (integer-valued float) disparity, masked.
      soft_disparity: ``[H, W]`` differentiable sub-pixel disparity, masked.
      mask: ``[H, W]`` confidence mask (1.0 where max correlation exceeds
        the threshold).
      confidence: ``[H, W]`` per-pixel maximum correlation value.
    """

    disparity: jax.Array
    soft_disparity: jax.Array
    mask: jax.Array
    confidence: jax.Array


class PipelineMaps(NamedTuple):
    """Batched disparity maps (all ``[B, H, W]``), without the volume."""

    disparity: jax.Array       # hard argmax disparity, masked
    soft_disparity: jax.Array  # sub-pixel soft-argmax disparity, masked
    mask: jax.Array            # confidence mask (max cost > threshold)
    confidence: jax.Array      # per-pixel max correlation


def soft_argmax(x: jax.Array, beta: float = 50.0, axis: int = -1) -> jax.Array:
    """Differentiable argmax: ``Σ_i softmax(βx)_i · i``.

    Mirrors the reference's ``soft_argmax`` (examples/verify.py:31-39,
    β=50.0 default) but works on any axis and is numerically stabilized
    (jax.nn.softmax subtracts the max, which the reference's
    ``torch.softmax`` also does internally).
    """
    weights = jax.nn.softmax(x * beta, axis=axis)
    indices = jnp.arange(x.shape[axis], dtype=x.dtype)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return jnp.sum(weights * indices.reshape(shape), axis=axis)


@functools.partial(
    jax.jit,
    static_argnums=(1,),
    static_argnames=("num_disparities", "threshold", "beta"))
def extract_disparity(
    cost_volume: jax.Array,
    num_disparities: Optional[int] = None,
    threshold: float = 0.6,
    beta: float = 50.0,
) -> DisparityResult:
    """Full disparity head: mask → argmax / soft-argmax → disparity.

    Args:
      cost_volume: ``[H, W, L]`` ZNCC cost volume.
      num_disparities: None if the volume is all-pairs (last axis =
        absolute projector column); the band size D if banded.  Must match
        how the volume was produced.
      threshold: confidence threshold on the per-pixel max correlation
        (reference constant 0.6, examples/verify.py:13).
      beta: soft-argmax temperature (reference constant 50.0, verify.py:12).

    Returns:
      A :class:`DisparityResult`.
    """
    if cost_volume.ndim != 3:
        raise ValueError(f"expected [H, W, L] volume, got {cost_volume.shape}")
    H, W, L = cost_volume.shape

    confidence = jnp.max(cost_volume, axis=-1)
    mask = (confidence > threshold).astype(cost_volume.dtype)

    corr_hard = jnp.argmax(cost_volume, axis=-1).astype(cost_volume.dtype)
    corr_soft = soft_argmax(cost_volume, beta=beta, axis=-1)

    if num_disparities is None:
        # correspondence is an absolute projector column: d = w − corr.
        template = jnp.arange(W, dtype=cost_volume.dtype)[None, :]
        disparity = (template - corr_hard) * mask
        soft_disparity = (template - corr_soft) * mask
    else:
        if L != num_disparities + 1:
            raise ValueError(
                f"banded volume last axis {L} != num_disparities+1 "
                f"({num_disparities + 1})")
        disparity = corr_hard * mask
        soft_disparity = corr_soft * mask

    return DisparityResult(disparity=disparity, soft_disparity=soft_disparity,
                           mask=mask, confidence=confidence)


def disparity_to_depth(
    disparity: jax.Array,
    focal_length: float,
    baseline: float,
    min_disparity: float = 1e-3,
) -> jax.Array:
    """Convert a disparity map to metric depth: ``Z = f·b / d``.

    Depth maps are the downstream product of structured-light matching
    (e.g. SLAM-style keyframe mapping); the reference repo stops at
    disparity, so this is new surface area.  Pixels with disparity below
    ``min_disparity`` (including masked-out zeros) map to depth 0.
    """
    safe = jnp.maximum(disparity, min_disparity)
    depth = focal_length * baseline / safe
    return jnp.where(disparity >= min_disparity, depth,
                     jnp.zeros_like(depth))
