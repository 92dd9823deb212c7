"""ZNCC stereo cost volume with an analytic custom VJP, in plain XLA.

This is the production op of the framework — a redesign of the
reference's CUDA extension (``custma.stereo_matching``,
custma/stereo_matching_wrapper.py:7-35 and
custma/src/stereo_matching_kernel.cu).  It is *not* a translation:

* The reference launches one CUDA thread per cost-volume element, each
  re-reading a k×k window twice (≈450 uncached global reads per element,
  kernel.cu:40-70).  Here the window statistics are computed **once per
  image** as separable box filters using the expanded-moments identity
  ``Σ(x−μx)(y−μy) = Σxy − ΣxΣy/k²``, and the cross term becomes either a
  row-Hankel matmul (all-pairs mode) or a 2-D box filter of the
  camera×shifted-projector product (banded mode).  Total work drops
  from O(H·W·D·k²) to O(H·W·D·k) with perfect vectorization.

* The reference backward scatters H·W·W·k² atomicAdd contributions through
  an ``[H, W, k, k]`` intermediate (kernel.cu:75-179).  Here the VJP is
  derived in closed form and evaluated as **gathers and box filters** (see ``_camera_grad_*`` below) — the race
  class is eliminated by construction.

Numerical contract (bit-parity targets with the reference):
  * zero-padded window reads, means divided by k² including padding
    (kernel.cu:6-12,53-54);
  * ``cost = (exy + eps)/sqrt(ex2*ey2 + eps)``, eps=1e-8 (kernel.cu:4,71);
  * backward omits the patch-mean chain-rule term exactly as the reference
    does (kernel.cu:135-148) — which equals full autodiff because centered
    window sums are identically zero;
  * residuals are the two input images (rematerialization strategy, like
    ``ctx.save_for_backward`` in custma/stereo_matching_wrapper.py:16);
  * only the camera image receives a gradient by default (the reference
    returns None for the projector, wrapper.py:33); the projector gradient
    is available as an extension via :func:`stereo_matching_with_proj_grad`.

Closed-form camera VJP (derivation):
  With ``n = exy + eps``, ``r = (ex2·ey2 + eps)^{-1/2}`` and upstream
  cotangent ``g[h,w,d]``, the reference's per-window-element gradient is
  ``g·(proj'·r − ey2·cam'·n·r³)`` (kernel.cu:145-148).  Summing all windows
  that contain pixel (y, x):

    cam_grad = A1 − box2d(Σ_d g·r·μy) − cam ⊙ box2d(B) + box2d(B·μx)

  where ``B = Σ_d g·ey2·n·r³`` and ``A1`` re-associates the proj'-value
  term: in banded mode ``A1 = Σ_d box2d(g·r)[y,x,d] · proj(y, x−d)``; in
  all-pairs mode the same sum has a diagonal-band structure
  (``A1[y,x] = Σ_e proj(y,e) · Σ_{rows} Σ_δ (g·r)[h, x+δ, e+δ]``).
  Every term is a box filter, gather, or matmul — no scatters.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

EPSILON = 1e-8  # reference: custma/src/stereo_matching_kernel.cu:4


# ---------------------------------------------------------------------------
# Box-filter primitives (zero-padded windowed sums)
# ---------------------------------------------------------------------------

def box2d(x: jax.Array, k: int) -> jax.Array:
    """k×k windowed sum over the leading two axes, zero-padded ("same").

    Matches the reference's window enumeration with query_ij zero padding
    (custma/src/stereo_matching_kernel.cu:6-12,42-52): ``out[h, w] =
    Σ_{|i|,|j| ≤ k//2} x[h+i, w+j]`` with out-of-bounds terms zero.
    Works on [H, W] and [H, W, ...] inputs (window is 1 on trailing axes).
    """
    p = k // 2
    strides = (1,) * x.ndim
    # Separable: k×1 rows pass then 1×k cols pass — O(2k) adds per element
    # instead of O(k²) for the fused window (k=15: 30 vs 225 taps).
    # NB: the init value must be the literal scalar 0 so XLA/JAX recognize
    # the add-monoid (differentiable reduce-window-sum); an array init
    # silently loses reverse-mode support.
    win_r = (k,) + (1,) * (x.ndim - 1)
    pad_r = [(p, p)] + [(0, 0)] * (x.ndim - 1)
    x = lax.reduce_window(x, 0.0, lax.add, win_r, strides, pad_r)
    win_c = (1, k) + (1,) * (x.ndim - 2)
    pad_c = [(0, 0), (p, p)] + [(0, 0)] * (x.ndim - 2)
    return lax.reduce_window(x, 0.0, lax.add, win_c, strides, pad_c)


def box_rows(x: jax.Array, k: int) -> jax.Array:
    """k-tap windowed sum over axis 0 only (used for the vertical pass of
    the all-pairs cross term)."""
    p = k // 2
    window = (k,) + (1,) * (x.ndim - 1)
    strides = (1,) * x.ndim
    padding = [(p, p)] + [(0, 0)] * (x.ndim - 1)
    return lax.reduce_window(x, 0.0, lax.add, window, strides, padding)


def _hankel_cols(img: jax.Array, k: int) -> jax.Array:
    """Row-wise Hankel expansion: out[h, w, j] = img_padded[h, w + j - k//2].

    Builds the [W, k] sliding-window view of each row so the all-pairs
    cross-moment becomes a per-row [W, k] @ [k, W] matmul (the same row-matmul structure as the reference's own golden torch path,
    examples/verify.py:116)."""
    p = k // 2
    H, W = img.shape
    padded = jnp.pad(img, ((0, 0), (p, p)))
    return jnp.stack([padded[:, j:j + W] for j in range(k)], axis=-1)


def _band_index(W: int, D: int) -> jax.Array:
    """[W, D+1] gather indices into a left-extended (by D) column axis:
    entry (w, d) addresses original column (w - d), always in range."""
    return (jnp.arange(W)[:, None] - jnp.arange(D + 1)[None, :]) + D


# ---------------------------------------------------------------------------
# Shared window statistics
# ---------------------------------------------------------------------------

def _image_moments(img: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Per-window sum S and centered second moment E2 = Σ(x−μ)² for every
    window center, via the expanded-moments identity."""
    k2 = jnp.asarray(k * k, img.dtype)
    s = box2d(img, k)
    s2 = box2d(img * img, k)
    e2 = s2 - s * s / k2
    return s, e2


# ---------------------------------------------------------------------------
# Forward implementations (pure jnp/XLA; also the recompute path of the VJP)
# ---------------------------------------------------------------------------

def _forward_allpairs(camera, projector, k, eps, precision):
    """All-pairs [H, W, W] cost volume (reference's actual behavior:
    D ignored, last axis = absolute projector column, kernel.cu:35-37,200)."""
    k2 = jnp.asarray(k * k, camera.dtype)
    sx, ex2 = _image_moments(camera, k)
    sy, ey2 = _image_moments(projector, k)

    cam_h = _hankel_cols(camera, k)   # [H, W, k]
    proj_h = _hankel_cols(projector, k)
    # G[h, w, d] = Σ_j cam_pad[h, w+j] · proj_pad[h, d+j]; rows independent.
    g = jnp.einsum("hwj,hdj->hwd", cam_h, proj_h,
                   preferred_element_type=camera.dtype, precision=precision)
    sxy = box_rows(g, k)
    exy = sxy - sx[:, :, None] * sy[:, None, :] / k2
    deno = jnp.sqrt(ex2[:, :, None] * ey2[:, None, :] + eps)
    return (exy + eps) / deno


def _banded_stats(camera, projector, D, k):
    """Window statistics shared by the banded forward and backward."""
    k2 = jnp.asarray(k * k, camera.dtype)
    sx, ex2 = _image_moments(camera, k)
    # Left-extend the projector by D zero columns so column (w - d) is a
    # plain gather; the zeros reproduce query_ij's left-of-image reads.
    proj_ext = jnp.pad(projector, ((0, 0), (D, 0)))
    sy_ext, ey2_ext = _image_moments(proj_ext, k)
    W = camera.shape[1]
    idx = _band_index(W, D)
    proj_band = proj_ext[:, idx]   # [H, W, D+1]
    sy_band = sy_ext[:, idx]
    ey2_band = ey2_ext[:, idx]
    sxy = box2d(camera[:, :, None] * proj_band, k)
    exy = sxy - sx[:, :, None] * sy_band / k2
    return sx, ex2, sy_band, ey2_band, proj_band, exy, k2


def _forward_banded(camera, projector, D, k, eps, precision):
    """Banded [H, W, D+1] cost volume: band d ↔ projector column (w − d) —
    the layout the reference intended but left commented out
    (kernel.cu:30-33,197)."""
    del precision  # banded path is box filters and elementwise work
    _, ex2, _, ey2_band, _, exy, _ = _banded_stats(camera, projector, D, k)
    deno = jnp.sqrt(ex2[:, :, None] * ey2_band + eps)
    return (exy + eps) / deno


def _forward(camera, projector, num_disparities, k, eps, precision):
    if camera.ndim != 2 or camera.shape != projector.shape:
        raise ValueError(
            f"expected matching [H, W] images, got {camera.shape} vs "
            f"{projector.shape}")
    if k < 1 or k % 2 != 1:
        # The reference implicitly assumes odd k via integer halving
        # (custma/src/stereo_matching_kernel.cu:44); make it explicit.
        raise ValueError(f"kernel_size must be odd and >= 1, got {k}")
    if num_disparities is None:
        return _forward_allpairs(camera, projector, k, eps, precision)
    return _forward_banded(camera, projector, num_disparities, k, eps,
                           precision)


# ---------------------------------------------------------------------------
# Closed-form camera-image VJP
# ---------------------------------------------------------------------------

def _camera_grad_banded(camera, projector, g, D, k, eps):
    """Banded-mode camera gradient: three box filters + elementwise ops."""
    sx, ex2, sy_band, ey2_band, proj_band, exy, k2 = _banded_stats(
        camera, projector, D, k)
    mux = sx / k2
    muy_band = sy_band / k2

    r = lax.rsqrt(ex2[:, :, None] * ey2_band + eps)
    n = exy + eps
    gr = g * r                                     # [H, W, D+1]
    b = jnp.sum(g * n * (r * r * r) * ey2_band, axis=-1)   # [H, W]
    grmu = jnp.sum(gr * muy_band, axis=-1)                  # [H, W]

    # proj'-value term: every window (h, w) within the k×k neighborhood of
    # (y, x) pairs pixel (y, x) with projector pixel (y, x − d).
    a1 = jnp.sum(box2d(gr, k) * proj_band, axis=-1)

    return a1 - box2d(grmu, k) + box2d(b * mux, k) - camera * box2d(b, k)


def _camera_grad_allpairs(camera, projector, g, cost, k, eps, precision):
    """All-pairs camera gradient, restructured for memory traffic.

    Two departures from the naive diagonal-band evaluation (which built
    the field ``M[h,x,e] = Σ_δ gr[h,x+δ,e+δ]`` with a k-iteration shift
    loop over volume-sized ``[H, W, W]`` arrays — ~k volume reads):

    * **Cost residual**: the forward volume ``cost`` is supplied (alive
      in autodiff anyway), so ``n·r = c`` turns the B-term into
      ``g·c·r²·ey2`` and eliminates the cross-term (Hankel matmul)
      recompute entirely.
    * **A1 via row-box + per-row matmul**: with ``G2 = box_rows(gr)``,

          A1[y,x] = Σ_{δ=−p..p} Σ_e G2[y, x+δ, e] · proj_pad[y, e−δ]
                  = Σ_j E[y, x+p−j, j],
          E[y,w,j] = Σ_e G2[y,w,e] · proj_pad[y, e+j−p]

      — ``E`` is a per-row ``[W, W] @ [W, k]`` matmul against the
      projector's Hankel view (K-dim = W deep), and the final sum
      is k cheap shifted ``[H, W]`` slices.  One volume read for the
      box, one for the matmul, no volume-sized shift loop.
    """
    p = k // 2
    k2 = jnp.asarray(k * k, camera.dtype)
    H, W = camera.shape
    sx, ex2 = _image_moments(camera, k)
    sy, ey2 = _image_moments(projector, k)
    mux = sx / k2
    muy = sy / k2

    r = lax.rsqrt(ex2[:, :, None] * ey2[:, None, :] + eps)
    gr = g * r
    # n·r³ = c·r² with c the saved forward plane.
    b = jnp.einsum("hwd,hd->hw", g * cost * (r * r), ey2,
                   preferred_element_type=camera.dtype, precision=precision)
    grmu = jnp.einsum("hwd,hd->hw", gr, muy,
                      preferred_element_type=camera.dtype, precision=precision)

    g2 = box_rows(gr, k)
    proj_h = _hankel_cols(projector, k)          # [H, W, k]
    e_field = jnp.einsum("ywe,yej->ywj", g2, proj_h,
                         preferred_element_type=camera.dtype,
                         precision=precision)
    e_pad = jnp.pad(e_field, ((0, 0), (p, p), (0, 0)))
    a1 = e_pad[:, 2 * p:2 * p + W, 0]
    for j in range(1, k):
        a1 = a1 + e_pad[:, 2 * p - j:2 * p - j + W, j]

    return a1 - box2d(grmu, k) + box2d(b * mux, k) - camera * box2d(b, k)


# ---------------------------------------------------------------------------
# Public op: custom_vjp (camera gradient only — reference parity)
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def _stereo_matching(
    camera: jax.Array,
    projector: jax.Array,
    num_disparities: Optional[int] = None,
    kernel_size: int = 15,
    epsilon: float = EPSILON,
    precision: Optional[str] = "highest",
) -> jax.Array:
    """Differentiable ZNCC stereo cost volume.

    The public-API analogue of ``custma.stereo_matching(camera, projector,
    D, kernel_size)`` (custma/stereo_matching_wrapper.py:35).  Deliberate
    deviation from the reference, documented in docs/PARITY.md: the
    reference *ignores* its D argument and always returns the all-pairs
    ``[H, W, W]`` volume (kernel.cu:14,194); here ``num_disparities=None``
    reproduces that behavior while an integer enables the banded
    ``[H, W, D+1]`` layout the reference intended.

    Only the camera image is differentiable, matching the reference
    backward (wrapper.py:33 returns None for every other input).  Use
    :func:`stereo_matching_with_proj_grad` if a projector gradient is
    needed.

    Args:
      camera: ``[H, W]`` float32 camera image.
      projector: ``[H, W]`` float32 projector (speckle) image.
      num_disparities: None → all-pairs; int D → banded ``[H, W, D+1]``.
      kernel_size: odd correlation window side.
      epsilon: numerical epsilon (1e-8 for reference parity).
      precision: "highest" for true float32 contractions (parity),
        "default"/None to let XLA pick (on a GPU, TF32: faster, ~10 bits).

    Returns:
      The cost volume.
    """
    return _forward(camera, projector, num_disparities, kernel_size, epsilon,
                    precision)


def _stereo_fwd(camera, projector, num_disparities, kernel_size, epsilon,
                precision):
    cost = _forward(camera, projector, num_disparities, kernel_size, epsilon,
                    precision)
    # Remat strategy, banded: save only the inputs, recompute statistics
    # in the backward (same choice as ctx.save_for_backward(camera,
    # projector), custma/stereo_matching_wrapper.py:16).  All-pairs: ALSO
    # save the forward volume — it is alive in autodiff anyway, and
    # ``n·r = c`` lets the backward skip the Hankel cross-term recompute
    # (docs/PARITY.md round-3 refinements).
    saved_cost = cost if num_disparities is None else None
    return cost, (camera, projector, saved_cost)


def _stereo_bwd(num_disparities, kernel_size, epsilon, precision, residuals,
                g):
    camera, projector, saved_cost = residuals
    if num_disparities is None:
        cam_grad = _camera_grad_allpairs(camera, projector, g, saved_cost,
                                         kernel_size, epsilon, precision)
    else:
        cam_grad = _camera_grad_banded(camera, projector, g, num_disparities,
                                       kernel_size, epsilon)
    # Projector is non-differentiable in the parity op (reference returns
    # None, wrapper.py:33): emit a symbolic zero so optimizers never see a
    # fake gradient.
    proj_grad = jnp.zeros_like(projector)
    return cam_grad, proj_grad


_stereo_matching.defvjp(_stereo_fwd, _stereo_bwd)

# Public entry point is pre-jitted (config args static): the op is built
# from ~100 XLA primitives, and eager per-primitive dispatch would defeat
# the fusion the whole design relies on.  Composes under an outer jit.
stereo_matching = jax.jit(_stereo_matching, static_argnums=(2, 3, 4, 5))
stereo_matching.__doc__ = _stereo_matching.__doc__


# ---------------------------------------------------------------------------
# Extension: projector gradient (beyond reference parity)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def stereo_matching_with_proj_grad(
    camera: jax.Array,
    projector: jax.Array,
    num_disparities: Optional[int] = None,
    kernel_size: int = 15,
    epsilon: float = EPSILON,
    precision: Optional[str] = "highest",
) -> jax.Array:
    """ZNCC cost volume that is differentiable in *both* images.

    The reference never implemented the projector gradient
    (custma/stereo_matching_wrapper.py:33).  This variant uses XLA autodiff
    of the moments-form forward, which is mathematically identical to the
    analytic gradient (the patch-mean chain terms cancel exactly).
    """
    return _forward(camera, projector, num_disparities, kernel_size, epsilon,
                    precision)
