"""Pipeline-parallel video demo: disparity-range stages over a mesh.

Runs a synthetic frame stream through
:func:`custereomatching_tpu.parallel.pipeline.pipelined_video_maps`:
stage ``s`` of ``S`` owns disparity planes ``[s·(D+1)/S, (s+1)·(D+1)/S)``
and frames flow through the stage ring, each stage handing its partial
online-softmax head state (four maps — not a volume) to the next over
``ppermute``.  The result is checked against the single-device
full-range matcher.

On a single host, validate the logic with virtual devices:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/pipeline_stages.py --stages 4

On S cards, steady-state throughput approaches S× the single-card rate
of a (D+1)/S-range match.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from custereomatching_tpu import StereoConfig, StereoMatcher
from custereomatching_tpu.data import make_video_batch
from custereomatching_tpu.parallel.pipeline import (
    pipelined_video_maps,
    stage_mesh,
)
from custereomatching_tpu.utils import disparity_metrics
from custereomatching_tpu.utils.cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--disparities", "-D", type=int, default=15,
                    help="D; D+1 planes must divide evenly into stages")
    ap.add_argument("--kernel-size", "-k", type=int, default=7)
    args = ap.parse_args()
    enable_compile_cache()

    n_dev = len(jax.devices())
    S = min(args.stages, n_dev)
    if (args.disparities + 1) % S:
        raise SystemExit(
            f"D+1={args.disparities + 1} must divide into {S} stages")
    cfg = StereoConfig(kernel_size=args.kernel_size,
                       num_disparities=args.disparities, backend="xla")
    mesh = stage_mesh(S)
    print(f"{S} pipeline stages over {n_dev} devices "
          f"({jax.devices()[0].platform}); {args.frames} frames "
          f"@ {args.height}x{args.width}, {args.disparities + 1} planes "
          f"-> {(args.disparities + 1) // S} per stage")

    cams, projs, disps = make_video_batch(
        args.frames, args.height, args.width, d_min=2.0,
        d_max=max(3.0, args.disparities * 0.6))
    cams, projs = jnp.asarray(cams), jnp.asarray(projs)

    piped = pipelined_video_maps(cams, projs, cfg, mesh)
    single = StereoMatcher(cfg)(cams, projs)

    hard_eq = bool(jnp.all(piped.disparity == single.disparity))
    soft_err = float(jnp.max(jnp.abs(piped.soft_disparity
                                     - single.soft_disparity)))
    m = disparity_metrics(piped.soft_disparity, jnp.asarray(disps),
                          piped.mask)
    print(f"vs single-device: hard disparity equal={hard_eq}, "
          f"soft max|diff|={soft_err:.2e}")
    print("accuracy vs truth: "
          + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
    print("PIPELINE-STAGES", "PASS" if hard_eq and soft_err < 1e-3
          else "FAIL")


if __name__ == "__main__":
    main()
