"""Image loading/saving (host-side; PIL backend — no OpenCV dependency).

PIL is imported where a file is decoded or written, so importing this
module (and everything that imports it) needs no imaging package.

Mirrors the reference's data-layer conventions (SURVEY §1 L1):
a stereo pair folder holds exactly img1.jpg (left) + img2.jpg (right)
(gui.py:96-100); calibration folders are globbed for *.jpg (gui.py:37).
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from stereo_reconstruction_cv_tpu.errors import DataError


def _pil_image():
    from PIL import Image

    return Image


def load_gray(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale, BT.601 luma (matches cv2.IMREAD_GRAYSCALE).

    Uses the native libjpeg decoder (bit-exact vs cv2.imread, releases the
    GIL) when available; PIL otherwise."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from stereo_reconstruction_cv_tpu import native

        img = native.load_image(path, gray=True)
        if img is not None:
            return img
    return np.asarray(_pil_image().open(path).convert("L"))


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from stereo_reconstruction_cv_tpu import native

        img = native.load_image(path, gray=False)
        if img is not None:
            return img
    return np.asarray(_pil_image().open(path).convert("RGB"))


def save_image(path: str, img: np.ndarray) -> None:
    _pil_image().fromarray(np.asarray(img)).save(path)


def load_stereo_pair(folder: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load the img1.jpg/img2.jpg pair convention (gui.py:96-100)."""
    p1 = os.path.join(folder, "img1.jpg")
    p2 = os.path.join(folder, "img2.jpg")
    if not os.path.exists(p1) or not os.path.exists(p2):
        raise DataError(
            f"stereo pair folder {folder!r} must contain img1.jpg and img2.jpg"
        )
    return load_gray(p1), load_gray(p2)


def glob_calibration_images(folder: str) -> List[str]:
    """Sorted *.jpg glob (gui.py:37)."""
    return sorted(glob.glob(os.path.join(folder, "*.jpg")))


def read_baseline(folder: str, default: float | None = None) -> float | None:
    """Read a loose baseline.txt like dataset/d3's '140mm'."""
    path = os.path.join(folder, "baseline.txt")
    if not os.path.exists(path):
        return default
    txt = open(path).read().strip().lower()
    mult = 1.0
    for suffix, m in (("mm", 1e-3), ("cm", 1e-2), ("m", 1.0)):
        if txt.endswith(suffix):
            txt = txt[: -len(suffix)].strip()
            mult = m
            break
    return float(txt) * mult
