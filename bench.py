"""Benchmark harness: KITTI-scale stereo matching on one GPU.

Workload: a full-resolution KITTI pair (1242×375) with 192 disparities,
kernel_size 15 — the production configuration.  The headline is the
inference path users run per frame (pair → disparity maps through
:meth:`StereoMatcher.disparity_maps`); ``vs_baseline`` is its fraction of
the volume-free roofline bound of the device (``utils.profiling``: the
larger of the memory and float32 compute legs, against published peaks).
That model counts scalar float32 window adds; the fused kernel sums its
windows with tensor-core band products, so ``vs_baseline`` is not yet a
roofline share of the code that runs.

Every timed call ends in ``jax.block_until_ready`` (the reference's
Timer never synchronizes the device and therefore measured launch
overhead only — reference: custma/utils.py + examples/verify.py:65-68).

Prints exactly one JSON line on stdout:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N}
Secondary numbers go to stderr, each with the device kind.  Refuses to
run off a GPU.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from custereomatching_tpu import StereoConfig
from custereomatching_tpu.models import PyramidStereoMatcher, StereoMatcher
from custereomatching_tpu.ops import stereo_matching
from custereomatching_tpu.utils import zncc_roofline
from custereomatching_tpu.utils.cache import enable_compile_cache

H, W, D, K = 375, 1242, 192, 15


def _time(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median seconds per call, each call ending in block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2
    enable_compile_cache()
    kind = jax.devices()[0].device_kind
    rng = np.random.default_rng(0)
    camera = jnp.asarray(rng.random((H, W), dtype=np.float32))
    projector = jnp.asarray(rng.random((H, W), dtype=np.float32))
    model = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D))

    maps = jax.jit(model.disparity_maps)
    t_pipe = _time(maps, camera[None], projector[None])
    fps = 1.0 / t_pipe
    bound = zncc_roofline(H, W, D, K, materialize_volume=False,
                          device_kind=kind)
    print(json.dumps({
        "metric": "kitti_stereo_pipeline_frames_per_s_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / bound["bound_fps"], 4),
    }), flush=True)

    B = 4
    t_batch = _time(maps, jnp.stack([camera] * B),
                    jnp.stack([projector] * B)) / B
    fwd = jax.jit(lambda c, p: stereo_matching(c, p, D, K))

    def fwd_bwd(c, p):
        # The reference's protocol: the volume is a real output, then the
        # backward with an all-ones cotangent (examples/verify.py:64-68).
        cost, pullback = jax.vjp(lambda x: stereo_matching(x, p, D, K), c)
        return cost, pullback(jnp.ones_like(cost))[0]

    def train_step(c, p, tgt):
        def loss(x):
            out = model.trainable_disparity_maps(x[None], p[None])
            return jnp.mean((out.soft_disparity[0] - tgt) ** 2)
        return jax.value_and_grad(loss)(c)

    pyr = PyramidStereoMatcher(model.config)
    t_fwd = _time(fwd, camera, projector)
    t_fb = _time(jax.jit(fwd_bwd), camera, projector)
    t_train = _time(jax.jit(train_step), camera, projector,
                    jnp.zeros_like(camera))
    t_pyr = _time(jax.jit(pyr), camera[None], projector[None])

    # The reference's own verify workload (330x422, D ignored → all-pairs
    # [H, W, W], k=15; reference examples/verify.py:10-13).
    cam_r = jnp.asarray(rng.random((330, 422), dtype=np.float32))
    proj_r = jnp.asarray(rng.random((330, 422), dtype=np.float32))
    ap = jax.jit(lambda c, p: stereo_matching(c, p, None, K))
    t_ap = _time(ap, cam_r, proj_r)
    t_ap_fb = _time(jax.jit(jax.grad(lambda c, p: jnp.sum(ap(c, p)))),
                    cam_r, proj_r)

    print(
        f"[bench] device={kind!r} backend={model.config.resolved_backend()} "
        f"kitti {H}x{W} D={D} k={K}: maps {t_pipe*1e3:.3f} ms "
        f"({fps:.1f} fps; roofline bound {bound['bound_s']*1e3:.3f} ms, "
        f"{bound['bound_by']}-bound), maps B={B} {t_batch*1e3:.3f} "
        f"ms/frame, pyramid {t_pyr*1e3:.3f} ms, train step "
        f"{t_train*1e3:.3f} ms, volume fwd {t_fwd*1e3:.3f} ms / fwd+bwd "
        f"{t_fb*1e3:.3f} ms; all-pairs 330x422 fwd {t_ap*1e3:.3f} ms / "
        f"fwd+bwd {t_ap_fb*1e3:.3f} ms",
        file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
