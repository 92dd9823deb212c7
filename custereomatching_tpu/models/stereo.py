"""Flagship model: the end-to-end structured-light stereo matcher.

In the reference the "model" only exists as example-script glue — cost
volume from the CUDA op plus a commented-out disparity pipeline
(reference: examples/verify.py:65-74, examples/test.py:71-86).  Here it
is a first-class, batched, jit/shard-friendly model object: image pair →
ZNCC cost volume → confidence mask → hard + soft disparity → optional
metric depth.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
from jax.sharding import Mesh

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.ops.disparity import (
    DisparityResult,
    PipelineMaps,
    extract_disparity,
)
from custereomatching_tpu.ops.fused import fused_disparity_maps
from custereomatching_tpu.ops.zncc import (
    _stereo_matching,
    stereo_matching_with_proj_grad,
)


class StereoOutput(NamedTuple):
    """Batched model outputs.

    Attributes:
      cost_volume: ``[B, H, W, L]`` ZNCC correlation volume.
      disparity: ``[B, H, W]`` hard disparity, confidence-masked.
      soft_disparity: ``[B, H, W]`` differentiable sub-pixel disparity.
      mask: ``[B, H, W]`` confidence mask.
      confidence: ``[B, H, W]`` per-pixel max correlation.
    """

    cost_volume: jax.Array
    disparity: jax.Array
    soft_disparity: jax.Array
    mask: jax.Array
    confidence: jax.Array


@dataclasses.dataclass(frozen=True)
class StereoMatcher:
    """Batched differentiable stereo matcher.

    A frozen-config callable (hashable, so it can be a static argument to
    jit).  ``__call__`` runs the full pipeline on a batch; use
    :meth:`cost_volume` / :meth:`disparity` for the stages separately, and
    :meth:`sharded_cost_volume` for the mesh-parallel path.

    The public-API superset of the reference: `custma.stereo_matching`
    (reference: custma/stereo_matching_wrapper.py:35) covered only the
    cost-volume stage for a single unbatched pair.
    """

    config: StereoConfig = StereoConfig()

    # -- single pair ------------------------------------------------------
    def cost_volume_single(self, camera: jax.Array,
                           projector: jax.Array) -> jax.Array:
        """ZNCC cost volume for one ``[H, W]`` pair.

        With ``config.grad_projector=True`` the op is differentiable in
        BOTH images (autodiff of the moments-form forward; the projector
        gradient is the half the reference never implemented,
        custma/stereo_matching_wrapper.py:33).
        """
        c = self.config
        op = (stereo_matching_with_proj_grad if c.grad_projector
              else _stereo_matching)
        return op(camera, projector, c.num_disparities, c.kernel_size,
                  c.epsilon, c.precision)

    # -- batched ----------------------------------------------------------
    def cost_volume(self, camera: jax.Array,
                    projector: jax.Array) -> jax.Array:
        """ZNCC cost volume for a ``[B, H, W]`` batch."""
        return jax.vmap(self.cost_volume_single)(camera, projector)

    def disparity(self, cost_volume: jax.Array) -> DisparityResult:
        """Batched disparity head over a ``[B, H, W, L]`` volume."""
        c = self.config
        head = functools.partial(
            extract_disparity, num_disparities=c.num_disparities,
            threshold=c.cost_threshold, beta=c.softargmax_beta)
        return jax.vmap(head)(cost_volume)

    def __call__(self, camera: jax.Array,
                 projector: jax.Array) -> StereoOutput:
        """Full pipeline on a ``[B, H, W]`` batch."""
        cv = self.cost_volume(camera, projector)
        d = self.disparity(cv)
        return StereoOutput(cost_volume=cv, disparity=d.disparity,
                            soft_disparity=d.soft_disparity, mask=d.mask,
                            confidence=d.confidence)

    # -- maps without the volume -------------------------------------------
    def disparity_maps(self, camera: jax.Array,
                       projector: jax.Array) -> PipelineMaps:
        """Batched ``[B, H, W]`` pair → disparity maps (inference).

        On the "pallas" backends a banded config runs the fused kernel
        (:func:`..ops.fused.fused_disparity_maps`): the cost volume never
        reaches device memory.  Otherwise, and in all-pairs mode, it is
        the volume op followed by the XLA head.  Not differentiable on
        the kernel path; for training use :meth:`trainable_disparity_maps`.
        """
        c = self.config
        backend = c.resolved_backend()
        if backend == "xla" or c.num_disparities is None:
            return self.trainable_disparity_maps(camera, projector)
        return fused_disparity_maps(
            camera, projector, c.num_disparities, c.kernel_size, c.epsilon,
            c.softargmax_beta, c.cost_threshold,
            interpret=backend == "pallas_interpret", precision=c.precision)

    def trainable_disparity_maps(self, camera: jax.Array,
                                 projector: jax.Array) -> PipelineMaps:
        """Differentiable batched ``[B, H, W]`` pair → disparity maps: the
        volume op (closed-form camera VJP) followed by the XLA head."""
        out = self(camera, projector)
        return PipelineMaps(disparity=out.disparity,
                            soft_disparity=out.soft_disparity,
                            mask=out.mask, confidence=out.confidence)

    def disparity_maps_lr(self, camera: jax.Array, projector: jax.Array,
                          tolerance: float = 1.0) -> PipelineMaps:
        """Disparity maps with left-right consistency checking.

        Runs :meth:`disparity_maps` in both directions (the right match is
        the left match of the horizontally flipped pair) and zeroes out
        pixels whose two estimates disagree by more than ``tolerance``
        px — occlusions and ambiguous matches that the confidence
        threshold alone misses.  Costs ~2× one pipeline pass.
        """
        from custereomatching_tpu.ops.consistency import lr_consistency_mask

        left = self.disparity_maps(camera, projector)
        right_f = self.disparity_maps(projector[:, :, ::-1],
                                      camera[:, :, ::-1])
        d_right = right_f.soft_disparity[:, :, ::-1]
        nd = self.config.num_disparities
        if nd is None:
            nd = camera.shape[-1] - 1
        check = jax.vmap(lambda dl, dr: lr_consistency_mask(
            dl, dr, nd, tolerance))
        lr = check(left.soft_disparity, d_right)
        mask = left.mask * lr
        return PipelineMaps(disparity=left.disparity * lr,
                            soft_disparity=left.soft_disparity * lr,
                            mask=mask, confidence=left.confidence)

    # -- mesh-sharded -----------------------------------------------------
    def sharded_cost_volume(self, camera: jax.Array, projector: jax.Array,
                            mesh: Mesh) -> jax.Array:
        """Cost volume sharded over a ``(data, space)`` mesh."""
        from custereomatching_tpu.parallel.sharded import sharded_cost_volume

        return sharded_cost_volume(camera, projector, self.config, mesh)

    def sharded_apply(self, camera: jax.Array, projector: jax.Array,
                      mesh: Mesh) -> StereoOutput:
        """Full pipeline with the volume sharded over ``mesh``.

        The disparity head is elementwise over the sharded axes (its
        reductions run along the unsharded disparity axis), so it needs no
        extra collectives — XLA keeps everything on-shard.
        """
        cv = self.sharded_cost_volume(camera, projector, mesh)
        d = self.disparity(cv)
        return StereoOutput(cost_volume=cv, disparity=d.disparity,
                            soft_disparity=d.soft_disparity, mask=d.mask,
                            confidence=d.confidence)
