"""Halo exchange of image border rows between spatial shards.

The reference is strictly single-GPU — its only parallelism is CUDA
threads over cost-volume elements (reference:
custma/src/stereo_matching_kernel.cu:28,194) and it has no collectives of
any kind (survey §2.4).  Scaling a k×k windowed correlation across a
device mesh requires each row-shard to see ``k//2`` rows of context from
its neighbors; this module implements that exchange with
``lax.ppermute`` between neighbouring devices — the structural analogue
of ring attention's block exchange, applied to image rows instead of KV
blocks.

Boundary semantics: ``lax.ppermute`` delivers **zeros** to devices that
receive nothing, so the first shard's top halo and the last shard's
bottom halo are zero-filled automatically — exactly the reference's
``query_ij`` zero-padding for out-of-image reads (reference:
custma/src/stereo_matching_kernel.cu:6-12).  A sharded computation on the
halo-extended block is therefore bit-identical to the unsharded one.

Everything here is differentiable: the transpose of a ``ppermute`` is the
inverted ``ppermute``, so gradients that land in halo rows flow back to
the neighbor shard that owns those rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def halo_exchange(x: jax.Array, halo: int, axis_name: str,
                  *, axis: int = 0) -> jax.Array:
    """Extend a row-sharded block with ``halo`` rows from each neighbor.

    Must be called inside a ``shard_map`` (or other SPMD context) where
    ``axis_name`` is a mesh axis along which ``x``'s ``axis`` is sharded.

    Args:
      x: the local block, e.g. ``[H_local, W]`` or ``[B, H_local, W]``.
      halo: number of context rows needed on each side (``kernel_size // 2``).
      axis_name: mesh axis name the rows are sharded over.
      axis: which array axis holds the sharded rows.

    Returns:
      The block extended to ``H_local + 2*halo`` rows along ``axis``:
      ``[neighbor-up rows | local rows | neighbor-down rows]``, with zeros
      where no neighbor exists (true image border).
    """
    if halo == 0:
        return x
    n = lax.axis_size(axis_name)
    size = x.shape[axis]
    if halo > size:
        raise ValueError(
            f"halo ({halo}) exceeds local shard extent ({size}); use fewer "
            f"'space' shards or a smaller kernel")
    if n == 1:
        # Single shard: no neighbor exists in either direction, so both
        # halos are the true-image-border zero fill — a plain pad, no
        # ppermute.  (Collectives on a size-1 axis are semantic no-ops
        # but not free; this keeps the mesh-1×1 path overhead-free.)
        pad = [(0, 0)] * x.ndim
        pad[axis] = (halo, halo)
        return jnp.pad(x, pad)
    # My bottom rows become the next shard's top halo; my top rows become
    # the previous shard's bottom halo.  Non-receivers get zeros (the
    # zero-pad convention at true image borders).
    my_bottom = lax.slice_in_dim(x, size - halo, size, axis=axis)
    my_top = lax.slice_in_dim(x, 0, halo, axis=axis)
    from_up = lax.ppermute(my_bottom, axis_name,
                           [(i, i + 1) for i in range(n - 1)])
    from_down = lax.ppermute(my_top, axis_name,
                             [(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([from_up, x, from_down], axis=axis)
