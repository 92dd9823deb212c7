"""Utilities, config validation, and driver entry-point tests."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu import Timer, TimerError, benchmark
from custereomatching_tpu.config import MeshConfig, StereoConfig
from custereomatching_tpu.utils import zncc_roofline


def test_timer_context_manager(capsys):
    """Reference-compatible ergonomics (custma/utils.py usage pattern)."""
    with Timer("elapsed {:.3f}s"):
        time.sleep(0.01)
    out = capsys.readouterr().out
    assert out.startswith("elapsed ") and out.strip().endswith("s")


def test_timer_since_checks():
    t = Timer(start=True)
    time.sleep(0.005)
    a = t.since_start()
    b = t.since_last_check()
    assert a >= 0.004
    assert 0 <= b <= a


def test_timer_error_when_not_running():
    t = Timer(start=False)
    with pytest.raises(TimerError):
        t.since_start()


def test_benchmark_returns_stats():
    f = jax.jit(lambda x: x * 2.0)
    stats = benchmark(f, jnp.ones((8, 8)), warmup=1, iters=3)
    assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]
    assert stats["iters"] == 3.0


@pytest.mark.parametrize("bad", [
    dict(kernel_size=4),                 # even
    dict(kernel_size=-3),
    dict(num_disparities=-1),
    dict(precision="float64"),
    dict(backend="cuda"),
])
def test_stereo_config_validation(bad):
    with pytest.raises(ValueError):
        StereoConfig(**bad)


def test_even_kernel_rejected_by_ops():
    from custereomatching_tpu.ops import fused_head_state, stereo_matching

    img = jnp.zeros((16, 16))
    with pytest.raises(ValueError):
        stereo_matching(img, img, 4, 6)
    with pytest.raises(ValueError):
        fused_head_state(img[None], img[None], 4, 6, 1e-8, 50.0, True)


def test_mesh_config():
    mc = MeshConfig(data=2, space=4)
    assert mc.shape == (2, 4) and mc.num_devices == 8


def test_roofline_model():
    h100 = "NVIDIA H100 80GB HBM3"
    rl = zncc_roofline(375, 1242, 192, 15, materialize_volume=True,
                       device_kind=h100)
    rf = zncc_roofline(375, 1242, 192, 15, materialize_volume=False,
                       device_kind=h100)
    assert rl["bound_fps"] > 0 and rf["bound_fps"] > 0
    # Materializing the volume moves ~100x more bytes.
    assert rl["bytes_moved"] > 10 * rf["bytes_moved"]


def test_graft_entry_points():
    """entry() compiles and runs; dryrun exercises the sharded train step
    on however many devices this test environment has."""
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (1, 96, 160)
    assert bool(jnp.isfinite(out).all())
    g.dryrun_multichip(len(jax.devices()))


def test_k1_window():
    """k=1 degenerates to per-pixel correlation (ZNCC of a single sample
    is eps-regularized 0/0); exercises the zero-halo path end to end."""
    from custereomatching_tpu.ops import stereo_matching
    from custereomatching_tpu.ops.golden import zncc_cost_volume

    rng = np.random.default_rng(0)
    cam = jnp.asarray(rng.random((8, 16), dtype=np.float32))
    proj = jnp.asarray(rng.random((8, 16), dtype=np.float32))
    got = np.asarray(stereo_matching(cam, proj, 3, 1))
    want = np.asarray(zncc_cost_volume(cam, proj, 3, 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_stereo_engine_bucketing():
    """Bucket padding is exact under the zero-pad convention: results for
    an odd-sized frame equal the direct (unpadded) computation."""
    from custereomatching_tpu.models import StereoEngine, StereoMatcher

    cfg = StereoConfig(kernel_size=5, num_disparities=6, backend="xla")
    engine = StereoEngine(cfg, buckets=[(32, 64), (64, 128)])
    rng = np.random.default_rng(0)
    cam = rng.random((27, 50)).astype(np.float32)
    proj = rng.random((27, 50)).astype(np.float32)
    got = engine.infer(cam, proj)
    want = StereoMatcher(cfg).disparity_maps(jnp.asarray(cam)[None],
                                             jnp.asarray(proj)[None])
    np.testing.assert_array_equal(got.disparity,
                                  np.asarray(want.disparity[0]))
    np.testing.assert_allclose(got.soft_disparity,
                               np.asarray(want.soft_disparity[0]),
                               rtol=1e-5, atol=1e-5)
    # batched + too-large frame errors
    got_b = engine.infer(cam[None], proj[None])
    assert got_b.disparity.shape == (1, 27, 50)
    with pytest.raises(ValueError):
        engine.infer(np.zeros((100, 300), np.float32),
                     np.zeros((100, 300), np.float32))
