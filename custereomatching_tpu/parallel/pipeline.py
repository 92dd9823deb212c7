"""Pipeline parallelism: stream frames through disparity-range stages.

The reference is single-GPU with no distributed layer (survey §2.4); the
survey's pipeline-parallel row ("stage video frames through stages
across hosts") is realized here as:

* The work is split along the **disparity dimension**: stage ``s`` of
  ``S`` owns disparity planes ``[s·(D+1)/S, (s+1)·(D+1)/S)``.  Every
  stage runs the SAME program (SPMD over mesh axis ``stage``), so the
  load is balanced by construction — no per-stage model surgery.
* What flows between stages is a frame's **online-softmax head state**
  — four ``[H, W]`` maps ``(m, am, s, t)`` — via ``lax.ppermute``.  The
  merge is the associative logsumexp combine that the fused kernel
  applies plane by plane (:mod:`..ops.fused`), so a frame
  that has visited all stages carries exactly the full-range result:
  soft-argmax ``t/s``, confidence ``m/β``, and FIRST-max hard argmax
  (ties resolve to the lower disparity, matching ``jnp.argmax`` and the
  reference pipeline's ``torch.argmax``, examples/test.py:78).
* Schedule: GPipe-style. At tick ``i`` stage ``s`` processes frame
  ``i − s``; after ``S−1`` warmup ticks every stage is busy, so a
  ``T``-frame stream completes in ``T + S − 1`` ticks of 1/S-range work
  — steady-state throughput approaches ``S×`` the single-device rate of
  the same per-stage op.

A stage's chunk runs the production banded op against a right-shifted
projector: correlating ``camera`` with ``shift_right(projector, off)``
over band width ``Dc`` enumerates exactly global disparities
``off..off+Dc`` (zero-fill preserves the reference's out-of-view
convention, custma/src/stereo_matching_kernel.cu:6-12).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.ops.disparity import PipelineMaps
from custereomatching_tpu.ops.fused import fused_head_state
from custereomatching_tpu.ops.zncc import _stereo_matching


class HeadState(NamedTuple):
    """Partial online-softmax disparity-head state (all ``[H, W]``).

    ``m``: running max of ``β·cost``; ``am``: its (global) disparity;
    ``s``/``t``: softmax sum and first-moment relative to ``m``.
    """

    m: jax.Array
    am: jax.Array
    s: jax.Array
    t: jax.Array


def empty_state(shape, dtype=jnp.float32) -> HeadState:
    return HeadState(m=jnp.full(shape, -3.0e38, dtype),
                     am=jnp.zeros(shape, dtype),
                     s=jnp.zeros(shape, dtype),
                     t=jnp.zeros(shape, dtype))


def chunk_state(camera: jax.Array, projector: jax.Array, d_offset,
                chunk: int, config: StereoConfig) -> HeadState:
    """Head state of disparity planes ``d_offset .. d_offset+chunk-1``.

    ``d_offset`` may be traced (each stage passes its own offset).

    On the "pallas" backends the stage runs the fused volume-free kernel
    over its planes; on "xla" the volume op and an XLA head.
    """
    off_cols = jnp.asarray(d_offset, jnp.int32)
    W = camera.shape[1]
    # Shifting right truncates the projector's last `off` columns, which
    # right-edge windows still need; pad BOTH images by the largest stage
    # offset (static, uniform across stages) and crop the volume after.
    pad_r = (config.num_disparities + 1) - chunk
    cam_p = jnp.pad(camera, ((0, 0), (0, pad_r)))
    proj_p = jnp.pad(projector, ((0, 0), (0, pad_r)))
    # shift_right(proj, off): column x holds projector[x - off], so band
    # index d enumerates global disparity off + d.
    proj_sh = _shift_right(proj_p, off_cols)
    backend = config.resolved_backend()
    if backend != "xla":
        st = fused_head_state(
            cam_p[None], proj_sh[None], chunk - 1, config.kernel_size,
            config.epsilon, config.softargmax_beta,
            backend == "pallas_interpret", config.precision)
        am, conf, s, t = (x[0, :, :W] for x in st)
        # Lift local state to global disparities: am += off and
        # t += off·s (Σ(d+off)·e = Σd·e + off·Σe).
        off = jnp.asarray(d_offset, am.dtype)
        return HeadState(m=config.softargmax_beta * conf, am=am + off, s=s,
                         t=t + off * s)
    cv = _stereo_matching(cam_p, proj_sh, chunk - 1, config.kernel_size,
                          config.epsilon, config.precision)[:, :W]
    beta = config.softargmax_beta
    bc = beta * cv                                     # [H, W, chunk]
    m = jnp.max(bc, axis=-1)
    am_local = jnp.argmax(bc, axis=-1)                 # first max
    e = jnp.exp(bc - m[:, :, None])
    s = jnp.sum(e, axis=-1)
    d_global = (jnp.arange(chunk, dtype=camera.dtype)[None, None, :]
                + jnp.asarray(d_offset, camera.dtype))
    t = jnp.sum(d_global * e, axis=-1)
    am = am_local.astype(camera.dtype) + jnp.asarray(d_offset, camera.dtype)
    return HeadState(m=m, am=am, s=s, t=t)


def _shift_right(img: jax.Array, off: jax.Array) -> jax.Array:
    """``out[y, x] = img[y, x - off]`` with zero fill (off >= 0, traced)."""
    H, W = img.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    # Gather-free: roll then mask the wrapped-in left margin.
    rolled = jnp.roll(img, off, axis=1)
    return jnp.where(cols >= off, rolled, 0.0)


def merge_states(low: HeadState, high: HeadState) -> HeadState:
    """Merge two partial states; ``low`` covers the LOWER disparities.

    Associative logsumexp combine; ties in the max resolve to ``low``
    (first-max semantics of the reference's argmax).
    """
    m = jnp.maximum(low.m, high.m)
    el = jnp.exp(low.m - m)
    eh = jnp.exp(high.m - m)
    take_low = low.m >= high.m
    return HeadState(
        m=m,
        am=jnp.where(take_low, low.am, high.am),
        s=low.s * el + high.s * eh,
        t=low.t * el + high.t * eh,
    )


def finalize_state(state: HeadState, config: StereoConfig) -> PipelineMaps:
    conf = state.m / config.softargmax_beta
    mask = (conf > config.cost_threshold).astype(conf.dtype)
    soft = jnp.where(state.s > 0, state.t / state.s, 0.0) * mask
    return PipelineMaps(disparity=state.am * mask, soft_disparity=soft,
                        mask=mask, confidence=conf)


def _stage_chunks(num_disparities: int, num_stages: int) -> int:
    """Planes per stage (last stage may cover padding planes; they are
    clamped inside chunk_state by construction of the shift)."""
    return -(-(num_disparities + 1) // num_stages)


def pipelined_video_maps(
    cameras: jax.Array,
    projectors: jax.Array,
    config: StereoConfig,
    mesh: Mesh,
    axis_name: str = "stage",
) -> PipelineMaps:
    """Run a ``[T, H, W]`` frame stream through the stage pipeline.

    Args:
      cameras, projectors: the video stream (replicated to all stages;
        only the four head-state maps travel between stages).
      config: banded :class:`StereoConfig` (``num_disparities`` is the
        full range; each stage searches ``(D+1)/S`` of it).
      mesh: a mesh with axis ``axis_name`` of size S.
      axis_name: the pipeline-stage mesh axis.

    Returns:
      ``PipelineMaps`` of ``[T, H, W]`` maps equal (to fp rounding) to
      the full-range single-device result.
    """
    if config.num_disparities is None:
        raise ValueError("pipeline parallelism requires banded mode")
    T, H, W = cameras.shape
    S = mesh.shape[axis_name]
    D = config.num_disparities
    if (D + 1) % S != 0:
        # Exact tiling keeps stages duplicate-free: an overlapping plane
        # would contribute twice to the softmax sums.
        raise ValueError(
            f"num_disparities+1 ({D + 1}) must divide evenly into "
            f"{S} stages; pad D so (D+1) % S == 0")
    chunk = _stage_chunks(D, S)

    def spmd(cams, projs):
        s_idx = lax.axis_index(axis_name)
        d_offset = s_idx * chunk   # exact tiling: S·chunk == D+1
        zero = empty_state((H, W), cams.dtype)

        def tick(carry, i):
            incoming = carry
            f = i - s_idx                       # frame this stage works on
            active = jnp.logical_and(f >= 0, f < T)
            fc = jnp.clip(f, 0, T - 1)
            cam = lax.dynamic_index_in_dim(cams, fc, 0, keepdims=False)
            proj = lax.dynamic_index_in_dim(projs, fc, 0, keepdims=False)
            part = chunk_state(cam, proj, d_offset, chunk, config)
            # First stage starts from empty; later stages merge upstream.
            base = jax.tree_util.tree_map(
                lambda z, x: jnp.where(s_idx == 0, z, x), zero, incoming)
            merged = merge_states(base, part)
            merged = jax.tree_util.tree_map(
                lambda mrg, z: jnp.where(active, mrg, z), merged, zero)
            # Ship to the next stage (ring; last stage's send is unused).
            perm = [(j, (j + 1) % S) for j in range(S)]
            outgoing = jax.tree_util.tree_map(
                lambda x: lax.ppermute(x, axis_name, perm), merged)
            return outgoing, merged

        _, states = lax.scan(tick, zero, jnp.arange(T + S - 1))
        # Stage S-1 holds frame f's COMPLETE state at tick i = f + S - 1;
        # slice those ticks.  Other stages' rows are partial garbage, but
        # every stage returns the same-shaped array (SPMD); the caller
        # reads the last stage's shard.
        full = jax.tree_util.tree_map(lambda x: x[S - 1:], states)
        maps = finalize_state(HeadState(*full), config)
        # [T, H, W] per stage -> stack on a leading stage axis so the
        # out_specs can shard it; only entry S-1 is meaningful.
        return jax.tree_util.tree_map(lambda x: x[None], maps)

    fn = jax.shard_map(
        spmd, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=PipelineMaps(*(P(axis_name),) * 4),
        # The scan carry starts replicated and becomes stage-varying
        # after the first ppermute, and stages may run a pallas_call;
        # skip the vma check.
        check_vma=False)
    out = fn(cameras, projectors)
    # The complete results live on the LAST stage's shard.
    return jax.tree_util.tree_map(lambda x: x[S - 1], out)


def stage_mesh(num_stages: int, devices=None) -> Mesh:
    """A 1-axis ``stage`` mesh over the first ``num_stages`` devices."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices[:num_stages]), ("stage",))
