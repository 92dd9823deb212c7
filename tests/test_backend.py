"""Backend routing, the device peak table and the compile-cache rule.

One place picks the backend (``StereoConfig.resolved_backend``): "auto"
is the fused kernel on a GPU and XLA elsewhere, and an explicit "pallas"
off a GPU raises instead of quietly interpreting.  Only
``disparity_maps`` reads it; volumes and gradients are XLA everywhere.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custereomatching_tpu.config import StereoConfig
from custereomatching_tpu.models import StereoMatcher


def _fake_platform(monkeypatch, platform):
    dev = types.SimpleNamespace(platform=platform, device_kind="fake")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "cpu", "xla"),
    ("auto", "gpu", "pallas"),
    ("xla", "gpu", "xla"),
    ("xla", "cpu", "xla"),
    ("pallas", "gpu", "pallas"),
    ("pallas_interpret", "cpu", "pallas_interpret"),
    ("pallas_interpret", "gpu", "pallas_interpret"),
])
def test_resolved_backend(monkeypatch, backend, platform, want):
    _fake_platform(monkeypatch, platform)
    assert StereoConfig(backend=backend).resolved_backend() == want


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_explicit_pallas_off_gpu_raises(monkeypatch, platform):
    _fake_platform(monkeypatch, platform)
    with pytest.raises(ValueError, match="pallas_interpret"):
        StereoConfig(backend="pallas").resolved_backend()


def test_explicit_pallas_raises_on_this_cpu():
    cfg = StereoConfig(kernel_size=3, num_disparities=2, backend="pallas")
    x = jnp.zeros((1, 8, 16), jnp.float32)
    with pytest.raises(ValueError, match="pallas_interpret"):
        StereoMatcher(cfg).disparity_maps(x, x)


@pytest.mark.parametrize("backend,num_disparities,fused", [
    ("pallas_interpret", 6, True),
    ("xla", 6, False),
    ("pallas_interpret", None, False),   # all-pairs: volume + head
])
def test_disparity_maps_routing(monkeypatch, backend, num_disparities, fused):
    from custereomatching_tpu.models import stereo

    calls = []
    real = stereo.fused_disparity_maps

    def spy(*a, **k):
        calls.append((k.get("interpret"), k.get("precision")))
        return real(*a, **k)

    monkeypatch.setattr(stereo, "fused_disparity_maps", spy)
    cfg = StereoConfig(kernel_size=5, num_disparities=num_disparities,
                       backend=backend)
    rng = np.random.default_rng(0)
    cam = jnp.asarray(rng.random((1, 12, 24), dtype=np.float32))
    out = StereoMatcher(cfg).disparity_maps(cam, cam)
    assert out.disparity.shape == (1, 12, 24)
    assert calls == ([(True, "highest")] if fused else [])


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_volume_and_grad_ignore_backend(backend):
    """The volume op and its gradient are the XLA op whatever the backend."""
    rng = np.random.default_rng(1)
    cam = jnp.asarray(rng.random((1, 10, 20), dtype=np.float32))
    proj = jnp.asarray(rng.random((1, 10, 20), dtype=np.float32))
    ref = StereoMatcher(StereoConfig(kernel_size=3, num_disparities=4,
                                     backend="xla"))
    m = StereoMatcher(StereoConfig(kernel_size=3, num_disparities=4,
                                   backend=backend))
    np.testing.assert_array_equal(np.asarray(m.cost_volume(cam, proj)),
                                  np.asarray(ref.cost_volume(cam, proj)))

    def loss(model, c):
        return jnp.sum(model.trainable_disparity_maps(c, proj).soft_disparity)

    np.testing.assert_array_equal(
        np.asarray(jax.grad(lambda c: loss(m, c))(cam)),
        np.asarray(jax.grad(lambda c: loss(ref, c))(cam)))


def test_engine_serves_fused_kernel():
    """The serving engine runs disparity_maps: on the interpreted kernel
    its bucket-padded answer equals the direct XLA maps (hard exactly
    here, soft to rounding)."""
    from custereomatching_tpu.models import StereoEngine

    kw = dict(kernel_size=5, num_disparities=6)
    eng = StereoEngine(StereoConfig(backend="pallas_interpret", **kw),
                       buckets=[(32, 64)])
    eng.warmup()
    rng = np.random.default_rng(0)
    cam = rng.random((27, 50)).astype(np.float32)
    proj = rng.random((27, 50)).astype(np.float32)
    got = eng.infer(cam, proj)
    want = StereoMatcher(StereoConfig(backend="xla", **kw)).disparity_maps(
        jnp.asarray(cam)[None], jnp.asarray(proj)[None])
    np.testing.assert_array_equal(got.disparity, np.asarray(want.disparity[0]))
    np.testing.assert_allclose(got.soft_disparity,
                               np.asarray(want.soft_disparity[0]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 4), (2, 4)])
def test_sharded_maps_on_xla_backend(mesh_shape):
    """sharded_disparity_maps runs on every backend (volume + head per
    shard on "xla") and matches the single-device maps."""
    from custereomatching_tpu.config import MeshConfig
    from custereomatching_tpu.parallel import (
        make_mesh, shard_batch, sharded_disparity_maps)

    rng = np.random.default_rng(7)
    cam = jnp.asarray(rng.random((2, 24, 36), dtype=np.float32))
    proj = jnp.asarray(rng.random((2, 24, 36), dtype=np.float32))
    cfg = StereoConfig(kernel_size=5, num_disparities=6, backend="xla")
    mesh = make_mesh(MeshConfig(data=mesh_shape[0], space=mesh_shape[1]))
    got = sharded_disparity_maps(*shard_batch((cam, proj), mesh), cfg, mesh)
    want = StereoMatcher(cfg).disparity_maps(cam, proj)
    np.testing.assert_array_equal(np.asarray(got.disparity),
                                  np.asarray(want.disparity))
    np.testing.assert_allclose(np.asarray(got.soft_disparity),
                               np.asarray(want.soft_disparity),
                               rtol=1e-5, atol=1e-5)


# -- device peaks -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_device_specs_unknown_kind_raises(kind):
    from custereomatching_tpu.utils import device_specs

    with pytest.raises(KeyError):
        device_specs(kind)


def test_device_specs_h100():
    from custereomatching_tpu.utils import device_specs

    spec = device_specs("NVIDIA H100 80GB HBM3")
    assert spec["hbm_bw"] == 3.35e12
    assert spec["fp32_flops"] == 67e12


def test_roofline_needs_known_device():
    """On this CPU there are no peaks: the roofline refuses, no default."""
    from custereomatching_tpu.utils import zncc_roofline

    with pytest.raises(KeyError):
        zncc_roofline(8, 8, 2, 3, materialize_volume=False)


# -- compilation cache ------------------------------------------------------

def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from custereomatching_tpu.utils import cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert updates == []          # jax reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from custereomatching_tpu.utils import cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert cache.compile_cache_dir() == want
    assert cache.enable_compile_cache() == want
    assert updates == [("jax_compilation_cache_dir", want)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero, with no JSON line, off a GPU."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
