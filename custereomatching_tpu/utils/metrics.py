"""Stereo evaluation metrics: end-point error and bad-pixel rates.

The reference has no metrics at all (its "verification" is a manual ipdb
comparison, examples/verify.py:154-156); accuracy here is stated in EPE
terms, so these are first-class.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp


def end_point_error(pred: jax.Array, truth: jax.Array,
                    mask: Optional[jax.Array] = None) -> jax.Array:
    """Mean absolute disparity error over (optionally masked) pixels."""
    err = jnp.abs(pred - truth)
    if mask is None:
        return jnp.mean(err)
    m = mask.astype(err.dtype)
    return jnp.sum(err * m) / jnp.maximum(jnp.sum(m), 1.0)


def bad_pixel_rate(pred: jax.Array, truth: jax.Array, threshold: float = 3.0,
                   mask: Optional[jax.Array] = None) -> jax.Array:
    """Fraction of (masked) pixels whose error exceeds ``threshold`` px
    (KITTI's D1 metric uses 3 px)."""
    bad = (jnp.abs(pred - truth) > threshold).astype(jnp.float32)
    if mask is None:
        return jnp.mean(bad)
    m = mask.astype(bad.dtype)
    return jnp.sum(bad * m) / jnp.maximum(jnp.sum(m), 1.0)


def disparity_metrics(pred: jax.Array, truth: jax.Array,
                      mask: Optional[jax.Array] = None) -> Dict[str, float]:
    """EPE + bad-1px/3px rates + coverage, as plain floats for reporting."""
    out = {
        "epe": float(end_point_error(pred, truth, mask)),
        "bad1": float(bad_pixel_rate(pred, truth, 1.0, mask)),
        "bad3": float(bad_pixel_rate(pred, truth, 3.0, mask)),
    }
    if mask is not None:
        out["coverage"] = float(jnp.mean(mask.astype(jnp.float32)))
    return out
