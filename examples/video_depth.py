"""Streaming keyframe depth — the north-star application.

The deployment this serves is "a keyframe depth-map front-end suitable
for SLAM-style mapping": a stream of stereo frames in, metric depth maps
out, at production rate.  This demo runs a synthetic video sequence
through the fused volume-free pipeline and reports per-frame latency,
sustained throughput and depth accuracy against ground truth.

Usage:
  python examples/video_depth.py --frames 32
  python examples/video_depth.py --height 375 --width 1242 -D 192  # KITTI
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from custereomatching_tpu import StereoConfig, StereoMatcher
from custereomatching_tpu.data import make_video_batch
from custereomatching_tpu.ops import disparity_to_depth
from custereomatching_tpu.utils import disparity_metrics
from custereomatching_tpu.utils.cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--height", type=int, default=375)
    ap.add_argument("--width", type=int, default=1242)
    ap.add_argument("--disparities", "-D", type=int, default=192)
    ap.add_argument("--kernel-size", "-k", type=int, default=15)
    ap.add_argument("--focal", type=float, default=700.0)
    ap.add_argument("--baseline", type=float, default=0.12)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--camera-pngs", nargs="*", default=None,
                    help="stream REAL camera frames from PNG files through "
                         "the native prefetching loader (decode overlaps "
                         "device compute); requires --projector-png")
    ap.add_argument("--projector-png", default=None)
    args = ap.parse_args()
    enable_compile_cache()

    if args.camera_pngs:
        return _stream_pngs(args)

    cams, projs, disps = make_video_batch(
        args.frames, args.height, args.width, d_min=4.0,
        d_max=min(args.disparities * 0.6, 40.0))
    model = StereoMatcher(StereoConfig(kernel_size=args.kernel_size,
                                       num_disparities=args.disparities,
                                       backend=args.backend))
    print(f"backend: {model.config.resolved_backend()}  "
          f"frames: {args.frames} @ {args.height}x{args.width}")

    @jax.jit
    def keyframe_depth(camera, projector):
        maps = model.disparity_maps(camera[None], projector[None])
        depth = disparity_to_depth(maps.soft_disparity[0], args.focal,
                                   args.baseline)
        return depth, maps.soft_disparity[0], maps.mask[0]

    # Pre-stage the sequence on device (frames arrive over the host bus in
    # production; this harness measures the device pipeline, not the
    # host-to-device transfer).
    cams_d = [jax.device_put(jnp.asarray(c)) for c in cams]
    projs_d = [jax.device_put(jnp.asarray(p)) for p in projs]

    # Warm up (compile), then stream the sequence like a SLAM front-end:
    # each frame dispatched as it "arrives", one wait at the end.
    jax.block_until_ready(keyframe_depth(cams_d[0], projs_d[0]))

    outputs = []
    t0 = time.perf_counter()
    for f in range(args.frames):
        outputs.append(keyframe_depth(cams_d[f], projs_d[f]))
    jax.block_until_ready(outputs[-1])
    dt = time.perf_counter() - t0
    print(f"streamed {args.frames} keyframes in {dt*1e3:.1f} ms "
          f"-> {args.frames/dt:.1f} depth maps/s "
          f"({dt/args.frames*1e3:.2f} ms/frame incl. host feed)")

    # Accuracy vs ground truth (last frame).
    depth, soft, mask = outputs[-1]
    truth = jnp.asarray(disps[-1])
    m = disparity_metrics(soft, truth, mask)
    depth_true = disparity_to_depth(truth, args.focal, args.baseline)
    valid = np.asarray(mask) > 0
    derr = np.abs(np.asarray(depth) - np.asarray(depth_true))[valid]
    print("disparity: " + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
    print(f"depth |err|: mean {derr.mean():.4f} m, p95 "
          f"{np.percentile(derr, 95):.4f} m over confident pixels")


def _stream_pngs(args) -> None:
    """Stream PNG camera frames via the native prefetching loader."""
    from custereomatching_tpu import native
    from custereomatching_tpu.data import load_image_gray

    if not args.projector_png:
        raise SystemExit("--camera-pngs requires --projector-png")
    proj = jnp.asarray(load_image_gray(args.projector_png))
    model = StereoMatcher(StereoConfig(kernel_size=args.kernel_size,
                                       num_disparities=args.disparities,
                                       backend=args.backend))

    @jax.jit
    def keyframe_depth(camera, projector):
        maps = model.disparity_maps(camera[None], projector[None])
        return disparity_to_depth(maps.soft_disparity[0], args.focal,
                                  args.baseline)

    n = 0
    t0 = time.perf_counter()
    with native.FrameLoader(args.camera_pngs) as frames:
        depth = None
        for cam in frames:   # decode of frame n+1 overlaps compute of n
            depth = keyframe_depth(jnp.asarray(cam), proj)
            n += 1
        jax.block_until_ready(depth)
    dt = time.perf_counter() - t0
    print(f"streamed {n} PNG keyframes in {dt*1e3:.1f} ms "
          f"-> {n/max(dt, 1e-9):.1f} depth maps/s "
          f"(native prefetch decode + device compute overlapped)")


if __name__ == "__main__":
    main()
