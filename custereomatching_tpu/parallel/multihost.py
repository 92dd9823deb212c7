"""Multi-process initialization and mesh construction.

The reference has no distributed communication layer whatsoever — no
NCCL/MPI/Gloo, no torch.distributed (survey §5.8).  Here
``jax.distributed.initialize()`` wires processes together and XLA runs
the collectives (NCCL between GPUs).  One process drives every card of
one host, so a single-host run needs none of this; call
:func:`initialize_multihost` once per process, before any JAX
computation, only when several processes share one job.

CI exercises the mesh logic on virtual CPU devices
(``--xla_force_host_platform_device_count``, see tests/conftest.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from custereomatching_tpu.config import MeshConfig


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Initialize JAX's distributed runtime for a multi-process job.

    Give all three arguments (e.g. ``"localhost:12345"``, 2, 0).  A
    single-process run (``num_processes`` None or 1) needs no runtime and
    returns at once; any failure of a multi-process initialization
    raises.
    """
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def make_global_mesh(config: MeshConfig) -> Mesh:
    """A ``(data, space)`` mesh over ALL processes' devices, in
    ``jax.devices()`` order.

    The cards of a host are joined all to all, so the layout follows the
    algorithm alone: rows of the device grid are ``data`` replicas,
    columns are ``space`` row-shards.
    """
    n = config.num_devices
    devices = jax.devices()
    if n != len(devices):
        raise ValueError(
            f"mesh {config.shape} needs exactly all {len(devices)} "
            f"global devices, got {n}")
    return Mesh(np.asarray(devices).reshape(config.shape),
                config.axis_names)


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a globally-sharded leading batch axis this process
    should feed (for ``jax.make_array_from_process_local_data``-style
    input pipelines)."""
    per = global_batch // jax.process_count()
    start = per * jax.process_index()
    return slice(start, start + per)
