"""Device-mesh construction for the sharded stereo pipeline.

No reference counterpart (the reference has no distributed layer at all
— no torch.distributed, NCCL, or multi-device code anywhere; survey
§2.4, §5.8).  The mesh has two axes:

* ``data``  — stereo frame pairs (batch / video frames): pure data
  parallelism, no communication in the forward pass.
* ``space`` — image rows (H): spatial tiling, the domain's analogue of
  sequence/context parallelism.  Requires a ``kernel_size//2``-row halo
  exchange between ring neighbors (see :mod:`.halo`).

The cards of one host are joined all to all, so devices are laid out in
``jax.devices()`` order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from custereomatching_tpu.config import MeshConfig


def make_mesh(config: MeshConfig,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ``Mesh`` with axes ``(data, space)`` from a :class:`MeshConfig`.

    Args:
      config: mesh layout (data × space device counts).
      devices: devices to use; defaults to all of ``jax.devices()``.

    Returns:
      A ``jax.sharding.Mesh``.
    """
    if devices is None:
        devices = jax.devices()
    n = config.num_devices
    if len(devices) < n:
        raise ValueError(
            f"mesh {config.shape} needs {n} devices, have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(config.shape)
    return Mesh(grid, config.axis_names)


def default_mesh_config(n_devices: int) -> MeshConfig:
    """Pick a reasonable (data, space) factorization for ``n_devices``.

    Prefers a 2-way spatial split (enough to exercise halo exchange)
    with the remainder on the batch axis; falls back to pure data
    parallelism for odd device counts.
    """
    space = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return MeshConfig(data=n_devices // space, space=space)
