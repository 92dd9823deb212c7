"""Configuration dataclasses for the stereo-matching engine.

The reference has no config system: its hyperparameters are module-level
constants in the example scripts (reference: examples/verify.py:10-13 —
``kernel_size=15, H, W, D = 330, 422, 200, softargmax_beta=50.0,
cost_volume_threshold=0.6``).  Here they become explicit, validated
configuration objects shared by the ops, models, benchmark harness and
the sharded pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Static configuration of the ZNCC stereo-matching op and pipeline.

    Attributes:
      kernel_size: side of the square correlation window (k). Must be odd
        (the reference implicitly assumes odd k via ``kernel_size / 2``
        integer halving, reference: custma/src/stereo_matching_kernel.cu:44).
      num_disparities: ``D``. ``None`` selects the all-pairs ``[H, W, W]``
        cost volume (the reference's actual behavior — it accepts D but
        ignores it, reference: custma/src/stereo_matching_kernel.cu:14,194).
        An integer selects the banded ``[H, W, D+1]`` volume the reference
        intended (its commented-out layout, kernel.cu:30-33,197), where
        band index d matches projector column ``w - d``.
      softargmax_beta: temperature for the differentiable soft-argmax head
        (reference: examples/verify.py:12,31-39).
      cost_threshold: confidence threshold on the per-pixel max correlation
        used to mask the disparity map (reference: examples/verify.py:13,74).
      epsilon: numerical epsilon; placement matters for bit-parity — added
        to the numerator and inside the sqrt of the denominator
        (reference: custma/src/stereo_matching_kernel.cu:4,71).
      grad_projector: if True the model layer routes through
        :func:`..ops.zncc.stereo_matching_with_proj_grad` so BOTH images
        receive gradients (XLA autodiff of the moments form).  The
        reference never implemented a projector gradient (its backward
        returns None, reference: custma/stereo_matching_wrapper.py:33);
        camera-only is therefore the parity default.
      precision: "highest" forces true float32 contractions (on a GPU the
        default would be TF32) for parity with the reference's fp32 CUDA
        accumulators, in the XLA ops and in the fused kernel's window
        sums; "default" lets XLA choose, and the fused kernel sums its
        windows in one TF32 pass.
      backend: how :meth:`..models.StereoMatcher.disparity_maps` runs.
        "pallas" — the fused volume-free kernel compiled for the GPU
        (:mod:`..ops.fused`, Pallas through Triton);
        "pallas_interpret" — the same kernel under the Pallas
        interpreter, on any platform (CPU testing);
        "xla" — the volume op followed by the XLA disparity head;
        "auto" — "pallas" on a GPU, "xla" otherwise.
        Every other path (volumes, gradients, training) is the XLA op of
        :mod:`..ops.zncc` whatever the backend.
    """

    kernel_size: int = 15
    num_disparities: Optional[int] = None
    softargmax_beta: float = 50.0
    cost_threshold: float = 0.6
    epsilon: float = 1e-8
    grad_projector: bool = False
    precision: str = "highest"
    backend: str = "auto"

    def __post_init__(self):
        if self.kernel_size < 1 or self.kernel_size % 2 != 1:
            raise ValueError(
                f"kernel_size must be odd and >= 1, got {self.kernel_size}")
        if self.num_disparities is not None and self.num_disparities < 0:
            raise ValueError(
                f"num_disparities must be None or >= 0, got {self.num_disparities}")
        if self.precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.backend not in ("auto", "xla", "pallas", "pallas_interpret"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def resolved_backend(self) -> str:
        """Resolve "auto" to a concrete backend for the current platform.

        An explicit "pallas" needs a GPU: elsewhere it raises rather than
        quietly interpreting the kernel.
        """
        if self.backend in ("xla", "pallas_interpret"):
            return self.backend
        import jax  # local: config must stay importable without device init

        platform = jax.devices()[0].platform
        if self.backend == "auto":
            return "pallas" if platform == "gpu" else "xla"
        if platform != "gpu":
            raise ValueError(
                f'backend="pallas" compiles the fused kernel for a GPU, but '
                f'the default device is {platform!r}; use '
                f'backend="pallas_interpret" to run it under the Pallas '
                f'interpreter, or "xla"')
        return "pallas"

    @property
    def pad(self) -> int:
        """Half-window (halo) size: rows/cols of context a window needs."""
        return self.kernel_size // 2

    def volume_shape(self, H: int, W: int) -> Tuple[int, int, int]:
        """Shape of the cost volume this config produces for an HxW pair."""
        if self.num_disparities is None:
            return (H, W, W)
        return (H, W, self.num_disparities + 1)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded pipeline.

    The reference is single-GPU with no distributed layer (survey §2.4);
    frames shard over ``data``; image rows shard over ``space`` with a
    halo exchange of ``kernel_size//2`` rows.
    """

    data: int = 1
    space: int = 1
    axis_names: Tuple[str, str] = ("data", "space")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.space)

    @property
    def num_devices(self) -> int:
        return self.data * self.space
