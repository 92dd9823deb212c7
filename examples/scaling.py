"""Mesh-scaling report: throughput and efficiency across mesh shapes.

The reference has no multi-device story at all (survey §2.4).  This
script runs the sharded pipeline over a sweep of ``(data, space)`` mesh
shapes and reports weak-scaling efficiency (per-device workload held
constant).  On several GPUs the halo ppermutes run over NCCL; without
them you can still validate the scaling *logic* with virtual CPU
devices:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/scaling.py --backend xla --height 64 --width 128

(CPU-mesh timings are host timings, not device numbers — the point of the
CPU run is the collective/sharding correctness and the efficiency
accounting; device numbers come from runs on the GPUs.)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from custereomatching_tpu.config import MeshConfig, StereoConfig
from custereomatching_tpu.data import make_video_batch
from custereomatching_tpu.models import StereoMatcher
from custereomatching_tpu.parallel import (
    make_mesh,
    shard_batch,
    sharded_cost_volume,
    sharded_disparity_maps,
)
from custereomatching_tpu.utils import benchmark
from custereomatching_tpu.utils.cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=128,
                    help="rows PER space-shard (weak scaling)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=1,
                    help="frames PER data-shard (weak scaling)")
    ap.add_argument("--disparities", "-D", type=int, default=32)
    ap.add_argument("--kernel-size", "-k", type=int, default=9)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--pipeline", choices=["fused", "volume"],
                    default="fused")
    ap.add_argument("--strong", action="store_true",
                    help="fixed GLOBAL problem size: reports sharding "
                         "overhead vs the single-device run (the "
                         "meaningful metric on shared-core virtual "
                         "devices, where weak-scaling per-device rates "
                         "fall as 1/n by construction)")
    ap.add_argument("--halo-breakdown", action="store_true",
                    help="also time the halo exchange alone (the "
                         "communication share of a sharded step)")
    args = ap.parse_args()
    enable_compile_cache()

    n = len(jax.devices())
    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    backend = config.resolved_backend()
    print(f"devices: {n} x {jax.devices()[0].device_kind!r}  "
          f"backend: {backend}  pipeline: {args.pipeline}")

    # Mesh sweep: every (data, space) factorization of 1, 2, 4, ..., n.
    shapes = []
    d = 1
    while d <= n:
        for s in (1, 2, 4, 8):
            if d * s <= n and (d * s) & (d * s - 1) == 0:
                shapes.append((d, s))
        d *= 2
    shapes = sorted(set(shapes), key=lambda x: (x[0] * x[1], x[1]))

    base_rate = None
    base_time = None
    if args.strong:
        print(f"{'mesh':>10} {'devices':>8} {'frames/s':>10} "
              f"{'step ms':>9} {'overhead':>9}")
    else:
        print(f"{'mesh':>10} {'devices':>8} {'frames/s':>10} "
              f"{'per-dev':>9} {'weak-eff':>9}")
    for (dd, ss) in shapes:
        if args.strong:
            # Fixed global problem: every mesh computes the same frames.
            max_d = max(d for d, _ in shapes)
            max_s = max(s for _, s in shapes)
            B = args.frames * max_d
            H = args.height * max_s
        else:
            B = args.frames * dd
            H = args.height * ss
        cams, projs, _ = make_video_batch(B, H, args.width,
                                          d_min=2.0, d_max=12.0)
        mesh = make_mesh(MeshConfig(data=dd, space=ss))
        cam_s, proj_s = shard_batch(
            (jnp.asarray(cams), jnp.asarray(projs)), mesh)

        if args.pipeline == "fused":
            fn = jax.jit(lambda c, p, m=mesh: sharded_disparity_maps(
                c, p, config, m).soft_disparity)
        else:
            fn = jax.jit(lambda c, p, m=mesh: sharded_cost_volume(
                c, p, config, m))
        stats = benchmark(fn, cam_s, proj_s, iters=10, warmup=2)
        rate = B / stats["median_s"]
        if args.strong:
            if base_time is None:
                base_time = stats["median_s"]
            ovh = stats["median_s"] / base_time - 1.0
            print(f"{dd}x{ss:>8} {dd*ss:>8} {rate:>10.2f} "
                  f"{stats['median_s']*1e3:>9.2f} {ovh*100:>+8.1f}%")
        else:
            per_dev = rate / (dd * ss)
            if base_rate is None:
                base_rate = per_dev
            eff = per_dev / base_rate
            print(f"{dd}x{ss:>8} {dd*ss:>8} {rate:>10.2f} {per_dev:>9.2f} "
                  f"{eff*100:>8.1f}%")

    if args.halo_breakdown and any(s > 1 for _, s in shapes):
        # Communication share: time the ppermute halo exchange alone on
        # the largest space mesh, vs the full sharded step above.
        from functools import partial

        from custereomatching_tpu.parallel.halo import halo_exchange

        ss = max(s for _, s in shapes)
        dd = max(d for d, s in shapes if s == ss)
        mesh = make_mesh(MeshConfig(data=dd, space=ss))
        B = args.frames * (dd if not args.strong else max(
            d for d, _ in shapes))
        H = args.height * (ss if not args.strong else max(
            s for _, s in shapes))
        cams, projs, _ = make_video_batch(B, H, args.width)
        cam_s, _ = shard_batch((jnp.asarray(cams), jnp.asarray(projs)),
                               mesh)
        halo = config.pad

        from jax.sharding import PartitionSpec as P

        halo_fn = jax.jit(jax.shard_map(
            partial(halo_exchange, halo=halo, axis_name="space", axis=1),
            mesh=mesh,
            in_specs=P("data", "space", None),
            out_specs=P("data", "space", None),
            check_vma=False))
        stats = benchmark(halo_fn, cam_s, iters=10, warmup=2)
        print(f"halo exchange alone ({dd}x{ss} mesh, {halo} rows): "
              f"{stats['median_s']*1e3:.3f} ms "
              f"(2 ppermutes of [{B}, {halo}, {args.width}] per image)")


if __name__ == "__main__":
    main()
