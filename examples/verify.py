"""Automated parity verification — the reference's verify.py, done right.

The reference's verification is manual: it computes the cost volume +
camera gradient along its CUDA path and its pure-torch path, then drops
into ipdb so the author can eyeball the two (reference:
examples/verify.py:154-156 — no assert anywhere).  This script formalizes
it: golden oracle vs the XLA op, forward values AND gradients under the
reference's own protocol (all-ones cotangent, verify.py:67-68) plus
random cotangents, and the fused volume-free kernel's maps vs the XLA
volume + head, with numeric tolerances and a nonzero exit code on
failure.

Default workload matches the reference's constants (H=330, W=422, k=15,
D=200; verify.py:10-13) on synthetic speckle data (the reference's input
PNGs are not in its repo).  Banded parity always runs; the all-pairs
[H, W, W] parity (the reference's actual output layout) is included
unless --skip-allpairs.

Usage:
  python examples/verify.py                # reference-sized workload
  python examples/verify.py --height 64 --width 96 --disparities 16 -k 9
  python examples/verify.py --pair pair.npz  # your own data
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
from custereomatching_tpu.data import load_stereo_pair_npy, make_stereo_pair
from custereomatching_tpu.ops import stereo_matching
from custereomatching_tpu.ops.golden import (
    zncc_camera_grad,
    zncc_cost_volume,
)
from custereomatching_tpu.utils import Timer
from custereomatching_tpu.utils.cache import enable_compile_cache


def check(name: str, got, want, rtol: float, atol: float) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    tol = atol + rtol * np.abs(want)
    ok = bool((err <= tol).all())
    print(f"  {'PASS' if ok else 'FAIL'}  {name}: max_abs_err="
          f"{err.max():.3e} (rtol={rtol:g}, atol={atol:g})")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=330)   # verify.py:10
    ap.add_argument("--width", type=int, default=422)
    ap.add_argument("--disparities", "-D", type=int, default=200)
    ap.add_argument("--kernel-size", "-k", type=int, default=15)
    ap.add_argument("--pair", type=str, default=None,
                    help=".npz/.npy stereo pair instead of synthetic data")
    ap.add_argument("--skip-allpairs", action="store_true")
    ap.add_argument("--interpret", action="store_true",
                    help="run the fused kernel under the Pallas interpreter "
                         "(any platform; without it the kernel needs a GPU)")
    args = ap.parse_args()
    enable_compile_cache()

    H, W, D, K = args.height, args.width, args.disparities, args.kernel_size
    if args.pair:
        cam_np, proj_np = load_stereo_pair_npy(args.pair)
        H, W = cam_np.shape
    else:
        cam_np, proj_np, _ = make_stereo_pair(
            H, W, d_min=2.0, d_max=min(D, 12.0), noise=0.01, seed=0)
    cam, proj = jnp.asarray(cam_np), jnp.asarray(proj_np)
    print(f"workload: H={H} W={W} D={D} k={K} "
          f"device={jax.devices()[0].device_kind!r}")

    ok = True

    # The patch-based golden oracle materializes [H, W, D+1, k²] in the
    # banded mode — intentionally simple, intentionally memory-hungry
    # (ops/golden.py docstring).  At reference/KITTI scale that exceeds
    # HBM, so the large-scale banded oracle is the XLA moments path,
    # which is itself pinned against the golden oracle at small scale
    # (here and in tests/).
    golden_banded = H * W * (D + 1) * K * K * 4 < 2_000_000_000
    oracle_name = "golden" if golden_banded else "xla (golden-pinned)"

    # ---- banded mode ----------------------------------------------------
    print("banded forward:")
    with Timer("  xla fwd    {:.3f}s"):
        cv_xla = jax.block_until_ready(stereo_matching(cam, proj, D, K))
    if golden_banded:
        with Timer("  golden fwd {:.3f}s"):
            cv_ref = jax.block_until_ready(zncc_cost_volume(cam, proj, D, K))
        ok &= check("xla vs golden", cv_xla, cv_ref, 1e-4, 1e-5)

        print("banded backward (all-ones cotangent, reference protocol):")
        g_xla = jax.grad(lambda c: jnp.sum(stereo_matching(c, proj, D, K)))(
            cam)
        g_ref = zncc_camera_grad(cam, proj, jnp.ones_like(cv_ref), D, K)
        scale = float(jnp.abs(g_ref).max())
        ok &= check("xla grad vs golden", g_xla / scale, g_ref / scale,
                    1e-4, 5e-6)

        print("banded backward (random cotangent):")
        rng = np.random.default_rng(7)
        gr = jnp.asarray(rng.standard_normal(cv_ref.shape).astype(np.float32))
        g_ref = zncc_camera_grad(cam, proj, gr, D, K)
        g_xla = jax.grad(lambda c: jnp.sum(
            stereo_matching(c, proj, D, K) * gr))(cam)
        scale = float(jnp.abs(g_ref).max())
        ok &= check("xla grad vs golden", g_xla / scale, g_ref / scale,
                    1e-4, 5e-6)
        del cv_ref, g_ref, gr
    else:
        print("  (golden skipped: its [H, W, D+1, k²] patches exceed 2 GB)")

    # ---- fused kernel vs the XLA volume + head --------------------------
    print("fused kernel maps vs xla volume + head:")
    backend = "pallas_interpret" if args.interpret else "pallas"
    fused = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D,
                                       backend=backend))
    xla = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D,
                                     backend="xla"))
    with Timer("  fused maps {:.3f}s"):
        got = jax.block_until_ready(fused.disparity_maps(cam[None],
                                                         proj[None]))
    want = xla.disparity_maps(cam[None], proj[None])
    # Hard disparities may differ only where two costs tie to rounding.
    diff = np.asarray(got.disparity) != np.asarray(want.disparity)
    cv = np.asarray(cv_xla)[None]
    gap = np.abs(
        np.take_along_axis(cv, np.asarray(got.disparity, int)[..., None], -1)
        - np.take_along_axis(cv, np.asarray(want.disparity, int)[..., None],
                             -1))[..., 0]
    ties = bool((gap[diff] <= 1e-5).all()) if diff.any() else True
    print(f"  {'PASS' if ties else 'FAIL'}  fused hard disparity: "
          f"{int(diff.sum())} pixels differ, all at ties: {ties}")
    ok &= ties
    ok &= check("fused soft disparity", got.soft_disparity,
                want.soft_disparity, 0.0, 1e-3)
    ok &= check("fused confidence", got.confidence, want.confidence,
                0.0, 1e-5)
    del cv_xla, cv

    # ---- all-pairs mode (the reference's actual [H, W, W] output) ------
    if not args.skip_allpairs:
        print("all-pairs forward + backward (reference layout [H, W, W]):")
        with Timer("  golden fwd {:.3f}s"):
            cv_gold = jax.block_until_ready(
                zncc_cost_volume(cam, proj, None, K))
        with Timer("  xla fwd    {:.3f}s"):
            cv_xla = jax.block_until_ready(
                stereo_matching(cam, proj, None, K))
        ok &= check("xla vs golden", cv_xla, cv_gold, 1e-4, 1e-5)
        del cv_xla, cv_gold
        g_gold = jax.block_until_ready(zncc_camera_grad(
            cam, proj, jnp.ones((H, W, W), jnp.float32), None, K))
        g_xla = jax.grad(
            lambda c: jnp.sum(stereo_matching(c, proj, None, K)))(cam)
        scale = float(jnp.abs(g_gold).max())
        ok &= check("xla grad vs golden", g_xla / scale, g_gold / scale,
                    1e-4, 5e-6)

    print("VERIFY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
