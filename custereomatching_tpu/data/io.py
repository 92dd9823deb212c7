"""Image / array IO for stereo pairs.

The reference loads its inputs with OpenCV and normalizes by 255, taking
channel 0 of the RGB camera frame (examples/verify.py:137-149); its
README also references a ``points.npy`` no script reads (README.md:32).
This module provides the equivalent loading surface, degrading gracefully
when OpenCV/PIL are absent, plus ``.npy`` pair loading so the
``points.npy``-style workload is actually usable.

A native C++ fast path (:mod:`..native`) is used automatically for PNG
decoding when the bundled library has been built; see
``custereomatching_tpu/native/README.md``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_image_gray(path: str, *, channel: Optional[int] = 0) -> np.ndarray:
    """Load an image as a [H, W] float32 array in [0, 1].

    Mirrors the reference's loading convention: ``/ 255`` normalization
    and channel 0 of color inputs (examples/verify.py:138-149).  Tries
    the native decoder first, then OpenCV, then PIL.
    """
    try:
        from custereomatching_tpu.native import decode_png_gray, native_available
        if native_available() and path.lower().endswith(".png"):
            img = decode_png_gray(path, channel if channel is not None else 0)
            if img is not None:
                return img
    except Exception:
        pass
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        arr = np.asarray(img)
        if arr.ndim == 3:
            # cv2 loads BGR; reference takes channel 0 of its RGB load —
            # for grayscale-ish speckle data any single channel matches.
            arr = arr[:, :, channel if channel is not None else 0]
        return (arr.astype(np.float32) / 255.0)
    except ImportError:
        pass
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[:, :, channel if channel is not None else 0]
    return arr.astype(np.float32) / 255.0


def png_decoder() -> Optional[str]:
    """The PNG decoder :func:`load_image_gray` uses: "native", "cv2",
    "PIL", or None when none is available."""
    from custereomatching_tpu.native import native_available

    if native_available():
        return "native"
    for name in ("cv2", "PIL"):
        try:
            __import__(name)
            return name
        except ImportError:
            pass
    return None


def load_stereo_pair_npy(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a stereo pair from a ``.npy``/``.npz`` file.

    Accepts either an ``.npz`` with ``camera``/``projector`` arrays or a
    single ``.npy`` of shape ``[2, H, W]`` — the ``points.npy``-style
    workload the reference's README names but never defines
    (README.md:32).
    """
    if path.endswith(".npz"):
        data = np.load(path)
        return (data["camera"].astype(np.float32),
                data["projector"].astype(np.float32))
    arr = np.load(path)
    if arr.ndim != 3 or arr.shape[0] != 2:
        raise ValueError(
            f"expected [2, H, W] array in {path}, got {arr.shape}")
    return arr[0].astype(np.float32), arr[1].astype(np.float32)


def save_stereo_pair_npz(path: str, camera: np.ndarray,
                         projector: np.ndarray,
                         disparity: Optional[np.ndarray] = None) -> None:
    """Save a (generated) stereo pair, optionally with ground truth."""
    arrays = {"camera": camera, "projector": projector}
    if disparity is not None:
        arrays["disparity"] = disparity
    np.savez(path, **arrays)


def save_disparity_png(path: str, disparity: np.ndarray,
                       max_disparity: Optional[float] = None) -> None:
    """Write a disparity map as an 8-bit PNG (like the reference's debug
    ``cv2.imwrite`` of its mask, examples/test.py:75)."""
    d = np.asarray(disparity, np.float32)
    scale = float(max_disparity) if max_disparity else max(float(d.max()), 1e-6)
    img = np.clip(d / scale * 255.0, 0, 255).astype(np.uint8)
    try:
        import cv2

        cv2.imwrite(path, img)
        return
    except ImportError:
        from PIL import Image

        Image.fromarray(img).save(path)
