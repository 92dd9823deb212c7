"""Mesh-sharded stereo pipeline: batched, spatially tiled, differentiable.

The reference processes one ``[H, W]`` pair on one GPU with no batch
dimension (reference: custma/stereo_matching_wrapper.py:11-14) and no
distributed layer (survey §2.4).  Here:

* frames shard over mesh axis ``data`` (pure DP, zero comms);
* image rows shard over mesh axis ``space`` with a ``kernel_size//2``-row
  halo exchange between neighbouring devices
  (:func:`..parallel.halo.halo_exchange`);
* the cost volume never materializes globally — each shard holds its
  ``[B/dp, H/sp, W, D+1]`` slice, and downstream reductions (disparity
  head, losses) are elementwise or along the *unsharded* disparity axis,
  so XLA inserts collectives only for final scalar metrics.

Bit-parity claim (tested in tests/test_parallel.py): for any mesh shape,
the sharded cost volume equals the single-device one, because the halo
exchange delivers exactly the neighbor rows a window needs and delivers
zeros at true image borders — the reference's ``query_ij`` convention
(reference: custma/src/stereo_matching_kernel.cu:6-12).
"""

from __future__ import annotations

import functools
import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.models.stereo import StereoMatcher
from custereomatching_tpu.ops.disparity import PipelineMaps
from custereomatching_tpu.parallel.halo import halo_exchange

# Canonical shardings for the pipeline's arrays.
IMAGE_SPEC = P("data", "space", None)          # [B, H, W]
VOLUME_SPEC = P("data", "space", None, None)   # [B, H, W, D+1]
MAP_SPEC = P("data", "space", None)            # [B, H, W] disparity/mask


def image_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``[B, H, W]`` image batches on ``mesh``."""
    return NamedSharding(mesh, IMAGE_SPEC)


def volume_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``[B, H, W, L]`` cost volumes on ``mesh``."""
    return NamedSharding(mesh, VOLUME_SPEC)


def _halo_extend(camera, projector, config: StereoConfig):
    """Per-shard ``[B_local, H_local, W]`` blocks extended by the halo rows
    their windows need (none on a single row-shard: the op's own zero
    padding is exactly the halo there)."""
    halo = config.pad if lax.axis_size("space") > 1 else 0
    return (halo, halo_exchange(camera, halo, "space", axis=1),
            halo_exchange(projector, halo, "space", axis=1))


def _crop(x, halo, rows):
    """Drop the outputs of windows centred in halo rows (they belong to the
    neighbour shard)."""
    return lax.slice_in_dim(x, halo, halo + rows, axis=1)


def _local_cost_volume(camera, projector, config: StereoConfig):
    """Per-shard volume (inside ``shard_map``): halo-extend, run, crop."""
    halo, cam_e, proj_e = _halo_extend(camera, projector, config)
    cv_e = StereoMatcher(config).cost_volume(cam_e, proj_e)
    return _crop(cv_e, halo, camera.shape[1])


def sharded_cost_volume(
    camera: jax.Array,
    projector: jax.Array,
    config: StereoConfig,
    mesh: Mesh,
) -> jax.Array:
    """Batched ZNCC cost volume, sharded over ``(data, space)``.

    Args:
      camera: ``[B, H, W]`` camera frames (B divisible by mesh.data,
        H divisible by mesh.space with ``H/space >= kernel_size//2``).
      projector: ``[B, H, W]`` projector frames.
      config: static op configuration.
      mesh: a ``(data, space)`` mesh from :func:`..parallel.mesh.make_mesh`.

    Returns:
      ``[B, H, W, L]`` cost volume with sharding ``P('data','space')`` on
      the first two axes.  Differentiable in ``camera`` (the analytic VJP
      runs per-shard; halo gradients flow back via the transposed
      ppermute).
    """
    fn = jax.shard_map(
        functools.partial(_local_cost_volume, config=config),
        mesh=mesh,
        in_specs=(IMAGE_SPEC, IMAGE_SPEC),
        out_specs=VOLUME_SPEC,
    )
    return fn(camera, projector)


def _local_disparity_maps(camera, projector, config: StereoConfig,
                          trainable: bool):
    """Per-shard maps (inside ``shard_map``): halo-extend, run, crop."""
    halo, cam_e, proj_e = _halo_extend(camera, projector, config)
    model = StereoMatcher(config)
    run = model.trainable_disparity_maps if trainable else model.disparity_maps
    maps_e = run(cam_e, proj_e)
    return PipelineMaps(*(_crop(m, halo, camera.shape[1]) for m in maps_e))


def sharded_disparity_maps(
    camera: jax.Array,
    projector: jax.Array,
    config: StereoConfig,
    mesh: Mesh,
    *,
    trainable: bool = False,
) -> PipelineMaps:
    """Disparity maps of a ``[B, H, W]`` batch, sharded over ``(data, space)``.

    Each shard runs :meth:`..models.StereoMatcher.disparity_maps` on its
    halo-extended rows — the fused volume-free kernel on the "pallas"
    backends.  ``trainable=True`` runs the differentiable volume + head
    instead (camera gradients flow; halo-row gradients return to their
    owner shard via the transposed ppermute).
    """
    if config.num_disparities is None:
        raise ValueError("sharded disparity maps require banded mode")
    fn = jax.shard_map(
        functools.partial(_local_disparity_maps, config=config,
                          trainable=trainable),
        mesh=mesh,
        in_specs=(IMAGE_SPEC, IMAGE_SPEC),
        out_specs=PipelineMaps(MAP_SPEC, MAP_SPEC, MAP_SPEC, MAP_SPEC),
        # A pallas_call declares no varying-mesh-axes on its outputs (and
        # the Pallas interpreter cannot carry them); skip the vma check.
        check_vma=False,
    )
    return fn(camera, projector)


def shard_batch(batch, mesh: Mesh):
    """Device-put a pytree of ``[B, H, W]`` arrays with the pipeline sharding."""
    sharding = image_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), batch)
