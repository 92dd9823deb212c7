"""Fused inference pipeline: stereo pair → disparity maps, volume-free.

The XLA path writes the banded ``[H, W, D+1]`` cost volume (360 MB per
KITTI frame) and reads it back in a separate disparity head.  This
Pallas kernel (Triton route) never writes it: each program owns a tile
of output pixels and walks all ``D+1`` disparities in a loop, folding
each cost plane into an online disparity head kept in registers —

* running max of the cost and its first arg-max (``jnp.argmax`` /
  ``torch.argmax`` tie-breaking);
* online-softmax sums ``s = Σ e^{β(c−m)}`` and ``t = Σ d·e^{β(c−m)}``,
  rescaled when the max improves, which give the reference's
  ``soft_argmax`` (examples/verify.py:31-39) as ``t/s``.

Device-memory traffic per frame drops to the two images, four window
statistics and four output maps.

The window statistics of each image (``Σx``, ``Σx²`` centred, and the
projector's at every virtual column ``w − d``) are ``[H, W]``-sized and
computed by XLA beforehand, with the same code as the volume op
(:func:`..zncc._image_moments`).  The kernel's own work is the cross
term ``Σ_window cam·proj(x − d)`` for every disparity: a k×k box sum of
a product that changes with ``d``.  Triton cannot shift a tile held in
registers, so the box sum is two products with 0/1 band matrices,
``Bv @ (cam ⊙ proj_d) @ Bh``, on extended tiles loaded at shifted
offsets.  The products run on the tensor cores over a split of the data
operand into TF32-exact parts (the band matrices are exact in TF32):
three parts at ``precision="highest"``, which represent float32 exactly,
or one at ``"default"``, plain TF32 like an XLA float32 matmul on the
card (:func:`_band_dot`).

The head returns the raw state ``(am, conf, s, t)``; with ``m = β·conf``
it is the :class:`..parallel.pipeline.HeadState` that pipeline stages
merge.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from custereomatching_tpu.ops.disparity import PipelineMaps
from custereomatching_tpu.ops.zncc import EPSILON, _image_moments

# Output tile (rows, columns) of one program, and its warps.  Chosen by
# measurement on an H100 at KITTI scale with the three-part split
# (PERF.md, "Kernel decisions").
BLOCK_ROWS = 16
BLOCK_COLS = 32
NUM_WARPS = 2


class FusedState(NamedTuple):
    """Raw head state of the fused kernel (all ``[B, H, W]``).

    ``conf`` is the max cost, ``am`` its first arg-max; ``s``/``t`` are
    the softmax sum and first moment relative to ``e^{β·conf}``.
    """

    am: jax.Array
    conf: jax.Array
    s: jax.Array
    t: jax.Array


def _tf32_round(x):
    """``x`` rounded to TF32's 11 significant bits (exact in TF32)."""
    bits = lax.bitcast_convert_type(x, jnp.uint32) + jnp.uint32(0x1000)
    return lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFE000),
                                    jnp.float32)


def _tf32_parts(x, n: int):
    """``x`` as ``n`` TF32-exact parts, smallest first: each part is the
    TF32 rounding of what the larger ones leave.  Three parts carry 33
    significant bits and sum to ``x`` exactly; one part is ``x`` to
    TF32's 2⁻¹¹ relative."""
    parts = []
    for _ in range(n):
        parts.append(_tf32_round(x))
        x = x - parts[-1]
    return parts[::-1]


PRECISION_PARTS = {"highest": 3, "default": 1}


def _band_dot(a, b, a_is_band, parts):
    """``a @ b`` where one operand is a 0/1 band matrix, on the tensor cores.

    The band matrix is exact in TF32; the other operand is split into
    ``parts`` TF32-exact parts (:func:`_tf32_parts`), one TF32 product
    each, summed smallest first.  With three parts every product term is
    exact and only the float32 accumulation rounds, as in a float32 dot.
    """
    acc = None
    for part in _tf32_parts(b if a_is_band else a, parts):
        lhs, rhs = (a, part) if a_is_band else (part, b)
        y = jnp.dot(lhs, rhs, precision=lax.Precision.DEFAULT,
                    preferred_element_type=jnp.float32)
        acc = y if acc is None else acc + y
    return acc


def _fused_kernel(cam_ref, proj_ref, sx_ref, ex2_ref, sy_ref, ey2_ref,
                  am_ref, conf_ref, s_ref, t_ref, *,
                  D: int, k: int, eps: float, beta: float, parts: int,
                  bh: int, bw: int, bhe: int, bwe: int):
    b = pl.program_id(0)
    h0 = pl.program_id(1) * bh
    w0 = pl.program_id(2) * bw
    span = k - 1
    k2 = float(k * k)

    # Row and column k-window sums as products with 0/1 band matrices:
    # output row a sums extended-tile rows a..a+k-1, likewise columns.
    ro = lax.broadcasted_iota(jnp.int32, (bh, bhe), 0)
    ri = lax.broadcasted_iota(jnp.int32, (bh, bhe), 1)
    band_v = ((ri >= ro) & (ri <= ro + span)).astype(jnp.float32)
    ci = lax.broadcasted_iota(jnp.int32, (bwe, bw), 0)
    co = lax.broadcasted_iota(jnp.int32, (bwe, bw), 1)
    band_h = ((ci >= co) & (ci <= co + span)).astype(jnp.float32)

    cam = cam_ref[b, pl.ds(h0, bhe), pl.ds(w0, bwe)]
    sx = sx_ref[b, pl.ds(h0, bh), pl.ds(w0, bw)]
    ex2 = ex2_ref[b, pl.ds(h0, bh), pl.ds(w0, bw)]

    def plane(d, carry):
        m, am, s, t = carry
        c0 = w0 + D - d            # column of virtual projector x − d
        proj = proj_ref[b, pl.ds(h0, bhe), pl.ds(c0, bwe)]
        rows = _band_dot(band_v, cam * proj, True, parts)
        sxy = _band_dot(rows, band_h, False, parts)
        sy = sy_ref[b, pl.ds(h0, bh), pl.ds(c0, bw)]
        ey2 = ey2_ref[b, pl.ds(h0, bh), pl.ds(c0, bw)]
        exy = sxy - sx * sy / k2
        cost = (exy + eps) / jnp.sqrt(ex2 * ey2 + eps)

        # One exp per plane: e^{−|β·c − β·m|} is the new term's weight
        # when c ≤ m and the old sums' rescale factor when c > m.
        better = cost > m
        ex = jnp.exp(-jnp.abs(cost * beta - m * beta))
        df = d.astype(jnp.float32)
        s = jnp.where(better, s * ex + 1.0, s + ex)
        t = jnp.where(better, t * ex + df, t + df * ex)
        return (jnp.where(better, cost, m), jnp.where(better, df, am), s, t)

    zeros = jnp.zeros((bh, bw), jnp.float32)
    init = (jnp.full((bh, bw), -jnp.inf, jnp.float32), zeros, zeros, zeros)
    m, am, s, t = lax.fori_loop(0, D + 1, plane, init)

    out = (b, pl.ds(h0, bh), pl.ds(w0, bw))
    am_ref[out] = am
    conf_ref[out] = m
    s_ref[out] = s
    t_ref[out] = t


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.partial(jax.jit, static_argnums=tuple(range(2, 8)))
def fused_head_state(camera: jax.Array, projector: jax.Array,
                     num_disparities: int, kernel_size: int = 15,
                     epsilon: float = EPSILON, beta: float = 50.0,
                     interpret: bool = False,
                     precision: str = "highest") -> FusedState:
    """Raw online disparity-head state of a ``[B, H, W]`` batch.

    ``interpret=True`` runs the kernel under the Pallas interpreter
    (any platform); otherwise it is compiled for the GPU through Triton.
    ``precision`` is :attr:`..config.StereoConfig.precision`: "highest"
    sums the windows at float32 precision, "default" in TF32.
    """
    if camera.ndim != 3 or camera.shape != projector.shape:
        raise ValueError(
            f"expected matching [B, H, W] batches, got {camera.shape} vs "
            f"{projector.shape}")
    if kernel_size < 1 or kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd and >= 1, got {kernel_size}")
    if precision not in PRECISION_PARTS:
        raise ValueError(f"unknown precision {precision!r}")
    B, H, W = camera.shape
    D, k = int(num_disparities), int(kernel_size)
    p = k // 2
    bh, bw = BLOCK_ROWS, BLOCK_COLS
    bhe, bwe = _next_pow2(bh + 2 * p), _next_pow2(bw + 2 * p)
    nh, nw = -(-H // bh), -(-W // bw)
    hp, wp = nh * bh, nw * bw

    moments = jax.vmap(functools.partial(_image_moments, k=k))
    sx, ex2 = moments(camera)
    # Projector statistics at every virtual column w − d ∈ [−D, W):
    # column c of the left-extended image is virtual column c − D.
    sy, ey2 = moments(jnp.pad(projector, ((0, 0), (0, 0), (D, 0))))

    def pad_to(x, rows, cols, top=0, left=0):
        return jnp.pad(x, ((0, 0), (top, rows - top - x.shape[1]),
                           (left, cols - left - x.shape[2])))

    # Extended tiles start k//2 rows/columns before their output tile.
    ext_r, ext_c = hp - bh + bhe, wp - bw + bwe
    cam_p = pad_to(camera, ext_r, ext_c, p, p)
    proj_p = pad_to(projector, ext_r, ext_c + D, p, p + D)
    sx, ex2 = (pad_to(x, hp, wp) for x in (sx, ex2))
    sy, ey2 = (pad_to(x, hp, wp + D) for x in (sy, ey2))

    kernel = functools.partial(
        _fused_kernel, D=D, k=k, eps=float(epsilon), beta=float(beta),
        parts=PRECISION_PARTS[precision], bh=bh, bw=bw, bhe=bhe, bwe=bwe)
    out = jax.ShapeDtypeStruct((B, hp, wp), jnp.float32)
    maps = pl.pallas_call(
        kernel,
        out_shape=(out,) * 4,
        grid=(B, nh, nw),
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="fused_stereo_pipeline",
    )(cam_p, proj_p, sx, ex2, sy, ey2)
    return FusedState(*(x[:, :H, :W] for x in maps))


def fused_disparity_maps(camera: jax.Array, projector: jax.Array,
                         num_disparities: int, kernel_size: int = 15,
                         epsilon: float = EPSILON, beta: float = 50.0,
                         threshold: float = 0.6, interpret: bool = False,
                         precision: str = "highest") -> PipelineMaps:
    """``[B, H, W]`` pair → disparity maps through the fused kernel.

    Equals the volume op followed by :func:`..disparity.extract_disparity`
    up to float32 rounding at ``precision="highest"``; inference only
    (not differentiable).
    """
    st = fused_head_state(camera, projector, num_disparities, kernel_size,
                          epsilon, beta, interpret, precision)
    mask = (st.conf > threshold).astype(st.conf.dtype)
    return PipelineMaps(disparity=st.am * mask,
                        soft_disparity=(st.t / st.s) * mask,
                        mask=mask, confidence=st.conf)
