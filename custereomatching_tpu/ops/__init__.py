"""Compute ops: ZNCC cost volume (oracle and XLA op), the disparity head,
and the fused volume-free inference kernel."""

from custereomatching_tpu.ops import golden
from custereomatching_tpu.ops.consistency import lr_consistency_mask
from custereomatching_tpu.ops.disparity import (
    DisparityResult,
    PipelineMaps,
    disparity_to_depth,
    extract_disparity,
    soft_argmax,
)
from custereomatching_tpu.ops.fused import (
    FusedState,
    fused_disparity_maps,
    fused_head_state,
)
from custereomatching_tpu.ops.zncc import (
    EPSILON,
    box2d,
    stereo_matching,
    stereo_matching_with_proj_grad,
)

__all__ = [
    "golden",
    "DisparityResult",
    "EPSILON",
    "FusedState",
    "PipelineMaps",
    "box2d",
    "disparity_to_depth",
    "extract_disparity",
    "fused_disparity_maps",
    "fused_head_state",
    "lr_consistency_mask",
    "soft_argmax",
    "stereo_matching",
    "stereo_matching_with_proj_grad",
]
