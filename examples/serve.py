"""Production serving loop: warm engine + native prefetch + failsafe.

Simulates the deployment shape the north star asks for: a stream of
camera frames (PNG files decoded ahead by the native ``FrameLoader``)
matched against a fixed projector pattern by a warm, shape-bucketed
``StereoEngine`` with transient-fault retry, with a device health probe
before serving and per-frame latency accounting.

Run against the checked-in capture (requires no downloads):

  python examples/serve.py
  python examples/serve.py --loops 8 --retries 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time


_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

import numpy as np  # noqa: E402

from custereomatching_tpu import StereoConfig, native  # noqa: E402
from custereomatching_tpu.data import load_image_gray  # noqa: E402
from custereomatching_tpu.models.engine import StereoEngine  # noqa: E402
from custereomatching_tpu.utils.cache import enable_compile_cache  # noqa: E402

DATA = os.path.join(_HERE, "data")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--camera-pngs", nargs="*", default=None,
                    help="camera frame files (default: the checked-in "
                         "capture, repeated --loops times)")
    ap.add_argument("--projector-png",
                    default=os.path.join(DATA, "capture_projector.png"))
    ap.add_argument("--loops", type=int, default=4)
    ap.add_argument("--num-disparities", type=int, default=48)
    ap.add_argument("--kernel-size", type=int, default=15)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args(argv)
    enable_compile_cache()

    frames = args.camera_pngs or [
        os.path.join(DATA, "capture_camera.png")] * args.loops
    proj = load_image_gray(args.projector_png)
    H, W = proj.shape
    bucket = (-(-H // 64) * 64, -(-W // 128) * 128)

    engine = StereoEngine(
        StereoConfig(kernel_size=args.kernel_size,
                     num_disparities=args.num_disparities,
                     backend=args.backend),
        buckets=[bucket], retries=args.retries)

    if not engine.healthy():
        print("SERVE: device health probe FAILED", file=sys.stderr)
        return 2
    print(f"device healthy; bucket {bucket[0]}x{bucket[1]}, "
          f"retries={args.retries}")
    t0 = time.perf_counter()
    engine.warmup()
    print(f"warmup (compile) {time.perf_counter() - t0:.1f}s")

    n = 0
    lat = []
    t_stream = time.perf_counter()
    if native.native_available():
        source = native.FrameLoader(frames)
        print(f"native prefetch loader over {len(frames)} frames")
    else:
        source = (load_image_gray(p) for p in frames)
        print("python decode fallback (native lib unavailable)")
    try:
        for cam in source:
            t1 = time.perf_counter()
            maps = engine.infer(cam, proj)
            # Serving returns host arrays, so the call has completed.
            cov = float((maps.mask > 0).mean())
            lat.append(time.perf_counter() - t1)
            n += 1
    finally:
        if hasattr(source, "close"):
            source.close()
    dt = time.perf_counter() - t_stream
    lat_ms = np.asarray(lat) * 1e3
    print(f"served {n} frames in {dt*1e3:.0f} ms "
          f"({n/max(dt, 1e-9):.1f} fps end-to-end incl. host IO); "
          f"per-frame p50 {np.percentile(lat_ms, 50):.1f} ms / "
          f"p95 {np.percentile(lat_ms, 95):.1f} ms; "
          f"last coverage {cov:.3f}")
    print("SERVE: OK" if n == len(frames) else "SERVE: INCOMPLETE")
    return 0 if n == len(frames) else 1


if __name__ == "__main__":
    raise SystemExit(main())
