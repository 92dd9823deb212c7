"""Left-right consistency checking for disparity maps.

A classic stereo validation the reference lacks entirely: match in both
directions and invalidate pixels whose two estimates disagree — occluded
or ambiguous regions that a single confidence threshold misses.

The right-to-left match reuses the same banded machinery via the
flip trick: matching the projector against the camera with the search
direction reversed equals running the standard left match on the
horizontally flipped pair.  The consistency gather ``d_R(x − d_L(x))``
is evaluated with the shift-select scan of models/pyramid.py, which
XLA fuses into one elementwise pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _select_shifted_f(src: jax.Array, k_map: jax.Array, lo: int,
                      hi: int) -> jax.Array:
    from custereomatching_tpu.models.pyramid import _select_shifted

    return _select_shifted(src, k_map, lo, hi)


def lr_consistency_mask(
    disparity_left: jax.Array,
    disparity_right: jax.Array,
    num_disparities: int,
    tolerance: float = 1.0,
) -> jax.Array:
    """``1.0`` where ``|d_L(x) − d_R(x − d_L(x))| <= tolerance``.

    Args:
      disparity_left: ``[H, W]`` camera-side disparity (left match).
      disparity_right: ``[H, W]`` projector-side disparity (right match),
        in the same convention (positive, leftward in camera coords).
      num_disparities: maximum disparity (bounds the gather scan).
      tolerance: max allowed |d_L − d_R| in pixels.
    """
    d_round = jnp.round(disparity_left)
    d_r_at = _select_shifted_f(disparity_right, d_round, 0,
                               int(num_disparities))
    ok = jnp.abs(disparity_left - d_r_at) <= tolerance
    return ok.astype(disparity_left.dtype)


def matched_pair_right(camera: jax.Array, projector: jax.Array):
    """The flipped pair whose standard left-match equals the right-match
    of the original pair: ``proj_flip`` as the new "camera", ``cam_flip``
    as the new "projector".  Flip the resulting maps back with
    ``flip_back``."""
    return projector[:, ::-1], camera[:, ::-1]


def flip_back(x: jax.Array) -> jax.Array:
    """Undo the horizontal flip on a map produced from the flipped pair."""
    return x[:, ::-1]
