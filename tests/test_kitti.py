"""KITTI data path: uint16/256 GT convention, layout detection, eval.

The reference consumes real captures with no loader (reference:
examples/verify.py:137-142); KITTI pairs are a parity workload.  These tests pin the KITTI loader round-trip (including the
native uint16 PNG decode) and the eval entry point on the checked-in
KITTI-format fixture.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from custereomatching_tpu.data import kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "kitti_fixture")


def test_disparity_roundtrip_exact(tmp_path):
    # Encode → decode must be exact at the uint16/256 grid, 0 = invalid.
    rng = np.random.default_rng(0)
    d = np.round(rng.uniform(0, 80, size=(13, 29)) * 256) / 256
    d[0, :5] = 0.0
    path = str(tmp_path / "disp.png")
    kitti.save_kitti_disparity(path, d)
    got, valid = kitti.load_kitti_disparity(path)
    np.testing.assert_array_equal(got, d.astype(np.float32))
    np.testing.assert_array_equal(valid, d > 0)


def test_native_u16_matches_python_decoder(tmp_path):
    from custereomatching_tpu import native

    if not native.native_available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 65536, size=(17, 23)).astype(np.uint16)
    path = str(tmp_path / "u16.png")
    kitti._write_png_gray(path, raw, 16)
    got = native.decode_png_u16(path)
    np.testing.assert_array_equal(got, raw)


def test_fixture_layout_and_frames():
    ld, rd, gd = kitti.detect_layout(FIXTURE)
    assert ld.endswith("image_2") and rd.endswith("image_3")
    assert gd.endswith("disp_occ_0")
    ids = kitti.list_frames(FIXTURE)
    assert ids == ["000000_10", "000001_10"]
    fr = kitti.load_frame(FIXTURE, ids[0])
    assert fr.camera.shape == fr.projector.shape == fr.gt_disparity.shape
    assert fr.camera.dtype == np.float32
    assert 0.0 <= fr.camera.min() and fr.camera.max() <= 1.0
    assert fr.gt_valid.all()          # synthetic GT is dense
    assert 2.0 <= fr.gt_disparity.max() <= 16.0


def test_kitti2012_layout(tmp_path):
    # Same loader serves the 2012 directory names.
    ids = kitti.write_fixture(str(tmp_path), num_frames=1, height=24,
                              width=48, max_disparity=6, seed=7)
    base = os.path.join(str(tmp_path), "training")
    os.rename(os.path.join(base, "image_2"), os.path.join(base, "colored_0"))
    os.rename(os.path.join(base, "image_3"), os.path.join(base, "colored_1"))
    os.rename(os.path.join(base, "disp_occ_0"), os.path.join(base, "disp_occ"))
    fr = kitti.load_frame(str(tmp_path), ids[0])
    assert fr.gt_disparity is not None and fr.camera.shape == (24, 48)


def test_eval_script_on_fixture():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "examples/kitti_eval.py", "--backend", "xla",
         "--kernel-size", "9"],
        capture_output=True, text=True, timeout=420, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "KITTI-EVAL PASS" in r.stdout
