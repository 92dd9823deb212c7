"""custereomatching_tpu — a differentiable ZNCC stereo-matching engine.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of the
CUDA reference ``lzhnb/CuStereoMatching``: a differentiable ZNCC stereo
cost volume with analytic backward, a fused volume-free disparity kernel
for the GPU, batched and mesh-sharded execution, and a benchmark harness.

Public API parity with the reference package (custma/__init__.py:1-6):
``stereo_matching``, ``Timer``, ``__version__`` — plus the extensions
(banded volumes, disparity head, sharded pipeline).
"""

from custereomatching_tpu.config import MeshConfig, StereoConfig
from custereomatching_tpu.models import (
    StereoMatcher,
    StereoOutput,
    TrainState,
    make_train_step,
    optimize_camera,
)
from custereomatching_tpu.ops import (
    DisparityResult,
    disparity_to_depth,
    extract_disparity,
    soft_argmax,
    stereo_matching,
    stereo_matching_with_proj_grad,
)
from custereomatching_tpu.parallel import (
    halo_exchange,
    make_mesh,
    shard_batch,
    sharded_cost_volume,
)
from custereomatching_tpu.utils import Timer, TimerError, benchmark
from custereomatching_tpu.version import __version__

__all__ = [k for k in globals() if not k.startswith("_")]
