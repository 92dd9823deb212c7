"""End-to-end demo: stereo pair → disparity map → depth, with metrics.

The product pipeline the reference only sketches in comments
(examples/test.py:78-86): cost volume → confidence mask → argmax /
soft-argmax → disparity, plus metric depth — here as a few lines against
the real API, on synthetic structured-light data with exact ground truth.

Usage:
  python examples/demo.py                     # fused pipeline on device
  python examples/demo.py --scene box --save-png /tmp/disp.png
  python examples/demo.py --backend xla       # the XLA fallback path
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
from custereomatching_tpu.data import make_stereo_pair, save_disparity_png
from custereomatching_tpu.ops import disparity_to_depth
from custereomatching_tpu.utils import benchmark, disparity_metrics
from custereomatching_tpu.utils.cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--width", type=int, default=1242)
    ap.add_argument("--disparities", "-D", type=int, default=192)
    ap.add_argument("--kernel-size", "-k", type=int, default=15)
    ap.add_argument("--scene", choices=["slant", "box"], default="slant")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_interpret"],
                    help="maps path: pallas = fused kernel (GPU), "
                         "pallas_interpret = same kernel interpreted, "
                         "xla = volume + XLA head, auto = pallas on a GPU")
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--save-png", type=str, default=None)
    ap.add_argument("--focal", type=float, default=700.0)
    ap.add_argument("--baseline", type=float, default=0.12)
    args = ap.parse_args()
    enable_compile_cache()

    cam, proj, disp_true = make_stereo_pair(
        args.height, args.width, scene=args.scene, d_min=2.0,
        d_max=min(args.disparities * 0.8, 40.0), noise=args.noise, seed=0)

    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    model = StereoMatcher(config)
    print(f"backend: {config.resolved_backend()}")

    cam_b = jnp.asarray(cam)[None]
    proj_b = jnp.asarray(proj)[None]
    pipeline = jax.jit(model.disparity_maps)
    maps = pipeline(cam_b, proj_b)

    m = disparity_metrics(maps.soft_disparity[0],
                          jnp.asarray(disp_true), maps.mask[0])
    print("metrics (soft disparity, confident pixels): "
          + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))

    depth = disparity_to_depth(maps.soft_disparity[0], args.focal,
                               args.baseline)
    valid = np.asarray(maps.mask[0]) > 0
    print(f"depth range over confident pixels: "
          f"[{float(np.asarray(depth)[valid].min()):.3f}, "
          f"{float(np.asarray(depth)[valid].max()):.3f}] m")

    stats = benchmark(pipeline, cam_b, proj_b, iters=20, warmup=3)
    print(f"pipeline latency: median {stats['median_s']*1e3:.2f} ms "
          f"({1.0/stats['median_s']:.1f} frames/s)")

    if args.save_png:
        save_disparity_png(args.save_png, np.asarray(maps.disparity[0]),
                           max_disparity=args.disparities)
        print(f"wrote {args.save_png}")


if __name__ == "__main__":
    main()
