"""Real-capture demo: checked-in PNG pair → native decode → disparity.

The analogue of the reference's verify run on its (absent from the repo)
real captures (/root/reference/examples/verify.py:136-157): loads the
committed 8-bit capture pair in ``examples/data/`` through the native
libpng decoder and the native .npy reader, runs the fused pipeline, and
scores the result against the ground-truth disparity.

Run:  python examples/real_capture.py [--backend xla]
Exit code 0 iff the confident-pixel EPE is under --max-epe.
"""

from __future__ import annotations

import argparse
import os
import sys


import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from custereomatching_tpu import StereoConfig, StereoMatcher  # noqa: E402
from custereomatching_tpu.data import load_image_gray  # noqa: E402
from custereomatching_tpu.utils import disparity_metrics  # noqa: E402
from custereomatching_tpu.utils.cache import enable_compile_cache  # noqa: E402

DATA = os.path.join(_HERE, "data")


def load_capture():
    """Load the committed capture pair, preferring the native decoders."""
    from custereomatching_tpu import native

    cam_path = os.path.join(DATA, "capture_camera.png")
    proj_path = os.path.join(DATA, "capture_projector.png")
    truth_path = os.path.join(DATA, "capture_disparity.npy")

    used_native = False
    if native.native_available():
        cam = native.decode_png_gray(cam_path)
        proj = native.decode_png_gray(proj_path)
        truth = native.load_npy_f32(truth_path)
        used_native = cam is not None and proj is not None and truth is not None
    if not used_native:
        cam = load_image_gray(cam_path)
        proj = load_image_gray(proj_path)
        truth = np.load(truth_path)
    return cam, proj, truth, used_native


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "xla", "pallas", "pallas_interpret"],
                    help="maps path: pallas = fused kernel (GPU), "
                         "pallas_interpret = same kernel interpreted, "
                         "xla = volume + XLA head, auto = pallas on a GPU")
    ap.add_argument("--num-disparities", type=int, default=48)
    ap.add_argument("--kernel-size", type=int, default=15)
    ap.add_argument("--max-epe", type=float, default=1.0,
                    help="pass threshold on confident-pixel EPE (px)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    cam, proj, truth, used_native = load_capture()
    print(f"loaded capture {cam.shape[0]}x{cam.shape[1]} "
          f"({'native C++ decoders' if used_native else 'python fallback'})")

    model = StereoMatcher(StereoConfig(
        kernel_size=args.kernel_size, num_disparities=args.num_disparities,
        backend=args.backend))
    maps = model.disparity_maps(jnp.asarray(cam)[None],
                                jnp.asarray(proj)[None])
    m = disparity_metrics(maps.soft_disparity[0], jnp.asarray(truth),
                          maps.mask[0])
    print(f"confident-pixel EPE {m['epe']:.4f} px, bad3 {m['bad3']:.4f}, "
          f"coverage {m['coverage']:.4f}")
    ok = float(m["epe"]) <= args.max_epe and float(m["coverage"]) > 0.5
    print("REAL-CAPTURE", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
