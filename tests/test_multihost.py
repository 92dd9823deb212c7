"""Tests for the multi-host surface (parallel/multihost.py).

Real multi-process runs need several hosts; everything CPU-testable is
covered here: single-process initialize semantics, global-mesh shape validation,
and the process-local batch-slice arithmetic (survey §5.8 — the subsystem
has no reference counterpart, so these tests are its spec).
"""

import jax
import numpy as np
import pytest

from custereomatching_tpu.config import MeshConfig
from custereomatching_tpu.parallel.multihost import (
    initialize_multihost,
    make_global_mesh,
    process_local_batch_slice,
)


def test_initialize_singleprocess_noop():
    """One process needs no distributed runtime: a no-op."""
    initialize_multihost()  # must not raise
    assert jax.process_count() == 1


def test_initialize_explicit_multiprocess_raises():
    """Asking for N>1 processes without a coordinator must fail loudly."""
    with pytest.raises(Exception):
        initialize_multihost(coordinator_address="127.0.0.1:1",
                             num_processes=2, process_id=0)


def test_make_global_mesh_full_cover():
    n = len(jax.devices())
    mesh = make_global_mesh(MeshConfig(data=n // 2, space=2))
    assert mesh.axis_names == ("data", "space")
    assert mesh.devices.shape == (n // 2, 2)
    assert len(set(np.asarray(mesh.devices).ravel())) == n


def test_make_global_mesh_rejects_partial_cover():
    """The global mesh must cover exactly all devices of all processes."""
    with pytest.raises(ValueError, match="global devices"):
        make_global_mesh(MeshConfig(data=1, space=1))


def test_process_local_batch_slice_single_process():
    s = process_local_batch_slice(12)
    assert (s.start, s.stop) == (0, 12)
    batch = np.arange(12)
    assert np.array_equal(batch[s], batch)


def test_process_local_batch_slice_arithmetic(monkeypatch):
    """Per-process slices partition the batch across simulated hosts."""
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    seen = []
    for pid in range(4):
        monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
        s = process_local_batch_slice(16)
        assert s.stop - s.start == 4
        seen.extend(range(s.start, s.stop))
    assert seen == list(range(16))


def test_global_mesh_runs_sharded_step():
    """The multihost mesh drives the real sharded train step (1 process)."""
    import jax.numpy as jnp
    import optax

    from custereomatching_tpu import StereoConfig, StereoMatcher
    from custereomatching_tpu.models import init_state, make_train_step
    from custereomatching_tpu.parallel import shard_batch

    n = len(jax.devices())
    mesh = make_global_mesh(MeshConfig(data=n // 2, space=2))
    k = 5
    model = StereoMatcher(StereoConfig(kernel_size=k, num_disparities=8))
    B, H, W = n // 2, 16, 32
    rng = np.random.default_rng(0)
    camera = jnp.asarray(rng.random((B, H, W), dtype=np.float32))
    projector = jnp.asarray(rng.random((B, H, W), dtype=np.float32))
    target = jnp.zeros((B, H, W), jnp.float32)
    camera, projector, target = shard_batch((camera, projector, target),
                                            mesh)
    optimizer = optax.adam(1e-2)
    state = init_state(camera, optimizer)
    step = make_train_step(model, optimizer, mesh)
    state, metrics = step(state, projector, target)
    assert np.isfinite(float(metrics.loss))
