"""Production serving engine: warm, shape-bucketed stereo inference.

XLA compiles per shape; a serving process fed variable-size frames would
recompile (30-90 s each) on every new resolution.  The engine maintains
a set of pre-compiled shape buckets and pads incoming frames up to the
smallest fitting bucket.

Padding is EXACT here, not approximate: the ZNCC windows treat
out-of-image pixels as zeros (the reference's ``query_ij`` convention,
custma/src/stereo_matching_kernel.cu:6-12), so extending an image with
zero rows/columns reproduces the border semantics bit-for-bit; the
padded region's outputs are cropped away.

The reference has no serving story (single script invocations); this is
the deployment surface the north star's "production serving" calls for.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.models.stereo import StereoMatcher
from custereomatching_tpu.ops.disparity import PipelineMaps

# Default buckets: KITTI-scale, VGA-scale, and a small tile.
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (128, 256), (384, 640), (384, 1280))


class StereoEngine:
    """Warm inference engine over a fixed set of (H, W) buckets.

    Example::

        engine = StereoEngine(StereoConfig(kernel_size=15,
                                           num_disparities=192))
        engine.warmup()                      # compile all buckets
        maps = engine.infer(camera, projector)   # numpy in, numpy out
    """

    def __init__(self, config: StereoConfig,
                 buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                 lr_check: bool = False, retries: int = 0):
        if config.num_disparities is None:
            raise ValueError("serving engine requires banded mode")
        self.config = config
        self.model = StereoMatcher(config)
        self.buckets = sorted(tuple(b) for b in buckets)
        self.lr_check = lr_check
        self.retries = retries
        self._fn = self._wrap(jax.jit(
            self.model.disparity_maps_lr if lr_check
            else self.model.disparity_maps))
        self._compiled: Dict[Tuple[int, int], bool] = {}

    def _wrap(self, fn):
        if self.retries:
            # The op is stateless, so re-dispatch on transient device
            # faults is safe (same inputs → same outputs).
            from custereomatching_tpu.utils.failsafe import with_retries

            return with_retries(fn, retries=self.retries)
        return fn

    def healthy(self) -> bool:
        """Device readiness probe (tiny verified computation)."""
        from custereomatching_tpu.utils.failsafe import device_healthcheck

        return device_healthcheck()

    def _bucket_for(self, H: int, W: int) -> Tuple[int, int]:
        for bh, bw in self.buckets:
            if H <= bh and W <= bw:
                return (bh, bw)
        raise ValueError(
            f"frame {H}x{W} exceeds every bucket {self.buckets}; "
            f"construct the engine with a larger bucket")

    def warmup(self) -> None:
        """Compile every bucket ahead of serving."""
        for bh, bw in self.buckets:
            z = jnp.zeros((1, bh, bw), jnp.float32)
            jax.block_until_ready(self._fn(z, z))
            self._compiled[(bh, bw)] = True

    def infer(self, camera: np.ndarray,
              projector: np.ndarray) -> PipelineMaps:
        """Run one stereo pair (or a batch) through the warm pipeline.

        Accepts ``[H, W]`` or ``[B, H, W]`` numpy/JAX arrays of any size
        fitting a bucket; returns numpy maps cropped to the input size.
        """
        cam = np.asarray(camera, np.float32)
        proj = np.asarray(projector, np.float32)
        if cam.shape != proj.shape:
            raise ValueError(f"shape mismatch {cam.shape} vs {proj.shape}")
        squeeze = cam.ndim == 2
        if squeeze:
            cam, proj = cam[None], proj[None]
        B, H, W = cam.shape
        bh, bw = self._bucket_for(H, W)
        pad = ((0, 0), (0, bh - H), (0, bw - W))
        maps = self._fn(jnp.asarray(np.pad(cam, pad)),
                                      jnp.asarray(np.pad(proj, pad)))
        crop = (lambda x: np.asarray(x)[0, :H, :W]) if squeeze else (
            lambda x: np.asarray(x)[:, :H, :W])
        return PipelineMaps(*(crop(m) for m in maps))
