"""Parallelism layer: device meshes, halo exchange, sharded pipeline.

Entirely new surface — the reference has no distributed or multi-device
code of any kind (survey §2.4, §5.8).
"""

from custereomatching_tpu.parallel.halo import halo_exchange
from custereomatching_tpu.parallel.mesh import default_mesh_config, make_mesh
from custereomatching_tpu.parallel.multihost import (
    initialize_multihost,
    make_global_mesh,
    process_local_batch_slice,
)
from custereomatching_tpu.parallel.pipeline import (
    pipelined_video_maps,
    stage_mesh,
)
from custereomatching_tpu.parallel.sharded import (
    IMAGE_SPEC,
    MAP_SPEC,
    VOLUME_SPEC,
    image_sharding,
    shard_batch,
    sharded_cost_volume,
    sharded_disparity_maps,
    volume_sharding,
)

__all__ = [k for k in globals() if not k.startswith("_")]
