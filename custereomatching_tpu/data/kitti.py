"""KITTI 2012/2015 stereo benchmark data path.

The reference consumes real captures but ships no loader (its verify
script hardcodes two PNG paths that are absent from the repo,
reference: examples/verify.py:137-142, .gitignore:10); this module makes
the framework's "KITTI pairs" workload runnable
on the actual benchmark data when a KITTI directory is present, and on
the tiny checked-in KITTI-format fixture otherwise
(tests/data/kitti_fixture).

Conventions implemented (the official KITTI stereo devkit ones):

* left/right images: 8- or 16-bit PNG, any channel count; loaded as
  [H, W] float32 in [0, 1] (channel 0 of color inputs — the reference's
  own convention, examples/verify.py:149);
* ground-truth disparity: **uint16 PNG, disparity_px = value / 256,
  value 0 = invalid** (both KITTI 2012 ``disp_occ``/``disp_noc`` and
  KITTI 2015 ``disp_occ_0``/``disp_noc_0``);
* directory layouts: KITTI 2015 (``image_2``/``image_3``), KITTI 2012
  (``colored_0``/``colored_1`` or ``image_0``/``image_1``), autodetected.

The left image plays the reference's "camera" role and the right image
its "projector": banded cost plane d correlates left pixel (h, w) with
right pixel (h, w−d), which is exactly the rectified-stereo disparity
convention KITTI ground truth uses.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from custereomatching_tpu.data.io import load_image_gray

# (left_dir, right_dir, [gt_dir candidates]) per supported layout.
_LAYOUTS = (
    ("image_2", "image_3", ("disp_occ_0", "disp_noc_0")),   # KITTI 2015
    ("colored_0", "colored_1", ("disp_occ", "disp_noc")),   # KITTI 2012
    ("image_0", "image_1", ("disp_occ", "disp_noc")),       # KITTI 2012 gray
)


class KittiFrame(NamedTuple):
    """One KITTI stereo frame, ready for the matcher."""

    camera: np.ndarray            # [H, W] float32 left image in [0, 1]
    projector: np.ndarray         # [H, W] float32 right image in [0, 1]
    gt_disparity: Optional[np.ndarray]  # [H, W] float32 px, 0 where invalid
    gt_valid: Optional[np.ndarray]      # [H, W] bool (GT present there)
    frame_id: str


def load_kitti_disparity(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a KITTI ground-truth disparity PNG.

    Returns ``(disparity, valid)``: float32 disparity in pixels
    (``uint16 value / 256``) and the validity mask (``value > 0``).
    Decodes through the native C++ path when available.
    """
    raw: Optional[np.ndarray] = None
    try:
        from custereomatching_tpu.native import decode_png_u16, native_available

        if native_available():
            raw = decode_png_u16(path)
    except Exception:
        raw = None
    if raw is None:
        import cv2

        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if raw is None:
            raise FileNotFoundError(path)
        raw = np.asarray(raw)
        if raw.ndim == 3:
            raw = raw[:, :, 0]
    raw = raw.astype(np.uint16)
    valid = raw > 0
    return raw.astype(np.float32) / 256.0, valid


def detect_layout(root: str) -> Tuple[str, str, str]:
    """Resolve (left_dir, right_dir, gt_dir) under ``root``.

    ``root`` may be the dataset root (containing ``training/``) or the
    split directory itself.  The GT directory may be absent (test
    splits); then the returned gt_dir is ''.
    """
    for base in (os.path.join(root, "training"), root):
        for left, right, gts in _LAYOUTS:
            ld = os.path.join(base, left)
            rd = os.path.join(base, right)
            if os.path.isdir(ld) and os.path.isdir(rd):
                gt = ""
                for cand in gts:
                    gd = os.path.join(base, cand)
                    if os.path.isdir(gd):
                        gt = gd
                        break
                return ld, rd, gt
    raise FileNotFoundError(
        f"no KITTI layout found under {root!r} (expected image_2/image_3, "
        f"colored_0/colored_1 or image_0/image_1)")


def list_frames(root: str) -> List[str]:
    """Frame ids (e.g. ``000003_10``) that have both images present."""
    ld, rd, _ = detect_layout(root)
    have_r = {f for f in os.listdir(rd) if f.endswith(".png")}
    return sorted(os.path.splitext(f)[0] for f in os.listdir(ld)
                  if f.endswith(".png") and f in have_r)


def load_frame(root: str, frame_id: str) -> KittiFrame:
    """Load one stereo frame (+ ground truth when present) by id."""
    ld, rd, gd = detect_layout(root)
    cam = load_image_gray(os.path.join(ld, f"{frame_id}.png"))
    proj = load_image_gray(os.path.join(rd, f"{frame_id}.png"))
    if cam.shape != proj.shape:
        raise ValueError(
            f"left/right size mismatch for {frame_id}: {cam.shape} vs "
            f"{proj.shape}")
    gt = valid = None
    if gd:
        gt_path = os.path.join(gd, f"{frame_id}.png")
        if os.path.exists(gt_path):
            gt, valid = load_kitti_disparity(gt_path)
    return KittiFrame(camera=cam, projector=proj, gt_disparity=gt,
                      gt_valid=valid, frame_id=frame_id)


def save_kitti_disparity(path: str, disparity: np.ndarray) -> None:
    """Write a disparity map in the KITTI submission encoding
    (uint16 PNG, ``value = round(256 · disparity)``, 0 = invalid)."""
    d = np.asarray(disparity, np.float32)
    enc = np.clip(np.round(d * 256.0), 0, 65535).astype(np.uint16)
    _write_png_u16(path, enc)


def _write_png_gray(path: str, arr: np.ndarray, depth: int) -> None:
    """Minimal 8/16-bit grayscale PNG writer (stdlib-only: zlib+struct).

    Kept dependency-free so fixtures and submission files can always be
    produced; big-endian sample order per the PNG spec.
    """
    import struct
    import zlib

    h, w = arr.shape
    if depth == 16:
        rows = arr.astype(">u2")
    elif depth == 8:
        rows = arr.astype(np.uint8)
    else:
        raise ValueError(f"unsupported bit depth {depth}")
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _write_png_u16(path: str, arr: np.ndarray) -> None:
    _write_png_gray(path, arr, 16)


def write_fixture(root: str, num_frames: int = 2, height: int = 40,
                  width: int = 96, max_disparity: int = 12,
                  seed: int = 0) -> List[str]:
    """Materialize a tiny KITTI-2015-format dataset for tests/examples.

    Synthetic speckle stereo pairs with known disparity, written in the
    official layout (``training/image_2``, ``image_3``, ``disp_occ_0``):
    8-bit images (the KITTI camera format), uint16/256 GT.  Returns
    frame ids.
    """
    from custereomatching_tpu.data.synthetic import make_stereo_pair

    base = os.path.join(root, "training")
    dirs = {n: os.path.join(base, n)
            for n in ("image_2", "image_3", "disp_occ_0")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    ids = []
    for i in range(num_frames):
        cam, proj, disp = make_stereo_pair(
            height, width, d_min=2.0, d_max=float(max_disparity),
            seed=seed + i)
        fid = f"{i:06d}_10"
        _write_png_gray(os.path.join(dirs["image_2"], f"{fid}.png"),
                        np.round(np.asarray(cam) * 255).astype(np.uint8), 8)
        _write_png_gray(os.path.join(dirs["image_3"], f"{fid}.png"),
                        np.round(np.asarray(proj) * 255).astype(np.uint8), 8)
        save_kitti_disparity(os.path.join(dirs["disp_occ_0"], f"{fid}.png"),
                             np.asarray(disp))
        ids.append(fid)
    return ids


__all__ = ["KittiFrame", "detect_layout", "list_frames", "load_frame",
           "load_kitti_disparity", "save_kitti_disparity", "write_fixture"]
