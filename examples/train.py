"""Camera-image optimization with checkpoint/resume.

The reference's differentiable path exists to optimize the camera image
(it is the only input with a gradient, custma/stereo_matching_wrapper.py:33),
but the reference ships no optimization loop, no optimizer and no
checkpointing.  This example is that loop, production-shaped: Adam over
the camera frames against a target disparity map through the volume op's
closed-form camera gradient, and orbax checkpointing so a killed run
resumes exactly where it stopped.

Usage:
  python examples/train.py --steps 200
  python examples/train.py --steps 400 --ckpt-dir /tmp/cst_ckpt   # resume
  python examples/train.py --mesh 2x4   # sharded over a (data, space) mesh
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax

from custereomatching_tpu import StereoConfig, StereoMatcher
from custereomatching_tpu.config import MeshConfig
from custereomatching_tpu.data import make_video_batch
from custereomatching_tpu.models import init_state, make_train_step
from custereomatching_tpu.models.optimize import TrainState
from custereomatching_tpu.parallel import make_mesh, shard_batch
from custereomatching_tpu.utils import disparity_metrics
from custereomatching_tpu.utils.cache import enable_compile_cache


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        sys.exit("--ckpt-dir needs the orbax-checkpoint package, which is "
                 "not installed (pip install orbax-checkpoint)")
    return ocp


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    ocp = _orbax()
    step = int(state.step)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, state, force=True)
    ckptr.wait_until_finished()


def restore_checkpoint(ckpt_dir: str, template: TrainState):
    ocp = _orbax()
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not steps:
        return None
    path = os.path.join(os.path.abspath(ckpt_dir), steps[-1])
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(path, template)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--disparities", "-D", type=int, default=24)
    ap.add_argument("--kernel-size", "-k", type=int, default=9)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--noise", type=float, default=0.05)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", type=str, default=None,
                    help="'DxS' mesh, e.g. 2x4 (needs D*S devices)")
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args()
    if args.ckpt_dir:
        _orbax()
    enable_compile_cache()

    cams, projs, _ = make_video_batch(args.frames, args.height, args.width,
                                      d_min=2.0,
                                      d_max=min(args.disparities * 0.7, 16.0))
    config = StereoConfig(kernel_size=args.kernel_size,
                          num_disparities=args.disparities,
                          backend=args.backend)
    model = StereoMatcher(config)
    print(f"backend: {config.resolved_backend()}  "
          f"devices: {len(jax.devices())}")

    mesh = None
    true_cam = jnp.asarray(cams)
    projector = jnp.asarray(projs)
    # Target = the disparity the TRUE camera produces; start from a noisy
    # camera and recover it.
    target = model.disparity_maps(true_cam, projector).soft_disparity
    rng = np.random.default_rng(0)
    camera0 = true_cam + args.noise * jnp.asarray(
        rng.standard_normal(true_cam.shape).astype(np.float32))

    if args.mesh:
        d, s = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(MeshConfig(data=d, space=s))
        camera0, projector, target = shard_batch(
            (camera0, projector, target), mesh)
        print(f"mesh: {mesh}")

    optimizer = optax.adam(args.lr)
    state = init_state(camera0, optimizer)
    if args.ckpt_dir:
        restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            if mesh is not None:
                # orbax restores to the default device; re-place the state
                # with the mesh shardings (camera-shaped leaves sharded,
                # scalars replicated) or jit sees mixed device sets.
                from jax.sharding import NamedSharding, PartitionSpec as P

                img_sh = NamedSharding(mesh, P("data", "space", None))
                rep = NamedSharding(mesh, P())

                def place(x):
                    x = jnp.asarray(x)
                    return jax.device_put(
                        x, img_sh if x.ndim == 3 else rep)

                state = jax.tree_util.tree_map(place, state)
            print(f"resumed from step {int(state.step)}")

    step_fn = make_train_step(model, optimizer, mesh)
    start = int(state.step)
    for i in range(start, args.steps):
        state, metrics = step_fn(state, projector, target)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i+1:5d}  loss {float(metrics.loss):.6f}  "
                  f"|grad| {float(metrics.grad_norm):.4f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state)
            print(f"checkpointed step {i+1}")

    final = model.disparity_maps(state.camera, projector)
    m = disparity_metrics(final.soft_disparity, target, final.mask)
    print("final disparity-vs-target: "
          + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
    cam_err = float(jnp.abs(state.camera - true_cam).mean())
    print(f"mean |camera - true_camera|: {cam_err:.5f} "
          f"(initial noise σ={args.noise})")


if __name__ == "__main__":
    main()
