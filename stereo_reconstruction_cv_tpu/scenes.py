"""Seeded synthetic stereo scenes with ground-truth disparity.

A scene is a stack of textured planes seen by a rectified pair: a slanted
background plane and a few rectangles and ellipses in front of it, each
with its own plane of disparity d(x, y) = a*x + b*y + c (left-image
coordinates) and its own multi-scale texture fixed to the surface. Both
views are rendered from that description with a z-buffer on disparity
(nearer = larger disparity wins), so the right view shows the same surface
texture shifted by the true, in general fractional, disparity, and the
pixels of the left view hidden in the right one are known exactly.

numpy only, deterministic in `seed`: tests, the benchmark and the device
smoke check make their inputs here instead of reading image files.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


# The reference rig: the Logitech 4K camera's calibrated K (main.ipynb
# cell 1 executed output) and the 140 mm baseline (dataset/d3/baseline.txt).
ANCHOR_K = np.array(
    [[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]],
    dtype=np.float64,
)
ANCHOR_BASELINE_M = 0.140


def anchor_k(width: int) -> np.ndarray:
    """ANCHOR_K scaled to an image `width` pixels wide (same aspect)."""
    K = ANCHOR_K.copy()
    K[:2] *= width / 3840.0
    return K


class StereoScene(NamedTuple):
    left: np.ndarray        # (H, W) uint8
    right: np.ndarray       # (H, W) uint8
    disparity: np.ndarray   # (H, W) float32, left view: x_right = x - d
    occluded: np.ndarray    # (H, W) bool: left pixel not visible in the right view


class _Layer(NamedTuple):
    a: float          # disparity plane d = a*x + b*y + c
    b: float
    c: float
    shape: str        # "all", "rect" or "ellipse"
    cx: float
    cy: float
    rx: float
    ry: float
    texture: np.ndarray  # (H, W + pad) float32, indexed by left-view x


def _value_noise(rng, H: int, W: int, cell: float) -> np.ndarray:
    """Bilinearly upsampled uniform noise with features of ~`cell` px."""
    gh = int(np.ceil(H / cell)) + 2
    gw = int(np.ceil(W / cell)) + 2
    g = rng.standard_normal((gh, gw)).astype(np.float32)
    ys = np.arange(H, dtype=np.float32) / cell
    xs = np.arange(W, dtype=np.float32) / cell
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    rows0 = g[y0]
    rows1 = g[y0 + 1]
    top = rows0[:, x0] * (1 - fx) + rows0[:, x0 + 1] * fx
    bot = rows1[:, x0] * (1 - fx) + rows1[:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def _texture(rng, H: int, W: int) -> np.ndarray:
    """Multi-scale texture, mean ~128, values in [0, 255]."""
    t = np.zeros((H, W), np.float32)
    for cell, amp in ((1.5, 1.0), (3.0, 0.9), (7.0, 0.8), (19.0, 0.6), (53.0, 0.5)):
        t += amp * _value_noise(rng, H, W, cell)
    t *= 42.0 / (float(t.std()) + 1e-6)
    t += rng.uniform(90.0, 166.0)
    return np.clip(t, 0.0, 255.0)


def _covers(layer: _Layer, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    if layer.shape == "all":
        return np.ones(np.broadcast(x, y).shape, bool)
    u = (x - layer.cx) / layer.rx
    v = (y - layer.cy) / layer.ry
    if layer.shape == "rect":
        return (np.abs(u) <= 1.0) & (np.abs(v) <= 1.0)
    return u * u + v * v <= 1.0


def _sample_row_linear(tex: np.ndarray, xl: np.ndarray) -> np.ndarray:
    """tex[y, xl] with linear interpolation along x (rows are shared by a
    rectified pair, so only x is fractional)."""
    H, Wt = tex.shape
    x = np.clip(xl, 0.0, Wt - 1.001)
    x0 = x.astype(np.int32)
    f = x - x0
    rows = np.arange(H)[:, None]
    return tex[rows, x0] * (1.0 - f) + tex[rows, x0 + 1] * f


def make_scene(
    height: int,
    width: int,
    num_disparities: int,
    seed: int = 0,
    n_objects: int = 6,
    noise_sigma: float = 1.0,
) -> StereoScene:
    """Render a seeded scene whose disparities lie in
    [0.08, 0.9] * num_disparities (inside an SGBM search range of
    `num_disparities` starting at 0)."""
    rng = np.random.default_rng(seed)
    H, W = height, width
    D = float(num_disparities)
    pad = int(np.ceil(D)) + 2  # right-view samples reach x_left up to W - 1 + d
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]

    layers = []
    # Background: a slanted plane over the whole frame, far (small d).
    d_lo, d_hi = 0.08 * D, 0.3 * D
    b = rng.uniform(0.0, 0.5) * (d_hi - d_lo) / H
    a = rng.uniform(-0.25, 0.25) * (d_hi - d_lo) / W
    c = d_lo + 0.5 * (d_hi - d_lo) - a * W / 2 - b * H / 2
    layers.append(_Layer(a, b, c, "all", 0, 0, 1, 1, _texture(rng, H, W + pad)))
    for k in range(n_objects):
        rx = rng.uniform(0.06, 0.2) * W
        ry = rng.uniform(0.08, 0.3) * H
        cx = rng.uniform(0.1, 0.95) * W
        cy = rng.uniform(0.1, 0.9) * H
        d_mid = rng.uniform(0.35, 0.85) * D
        a = rng.uniform(-0.04, 0.04) * D / W
        b = rng.uniform(-0.04, 0.04) * D / H
        c = d_mid - a * cx - b * cy
        shape = "rect" if k % 2 == 0 else "ellipse"
        layers.append(_Layer(a, b, c, shape, cx, cy, rx, ry,
                             _texture(rng, H, W + pad)))

    # Left view: z-buffer at integer x.
    dL = np.full((H, W), -np.inf, np.float32)
    kL = np.zeros((H, W), np.int32)
    for k, ly in enumerate(layers):
        d = ly.a * xs + ly.b * ys + ly.c
        take = _covers(ly, xs, ys) & (d > dL)
        dL = np.where(take, d, dL)
        kL = np.where(take, k, kL)
    left = np.zeros((H, W), np.float32)
    for k, ly in enumerate(layers):
        m = kL == k
        left[m] = np.broadcast_to(ly.texture[:, :W], (H, W))[m]

    # Right view: pixel xr sees, on layer k, the left-view point
    # xl = (xr + b*y + c) / (1 - a), since xr = xl - d(xl, y).
    dR = np.full((H, W), -np.inf, np.float32)
    kR = np.zeros((H, W), np.int32)
    xlR = np.zeros((H, W), np.float32)
    for k, ly in enumerate(layers):
        xl = (xs + ly.b * ys + ly.c) / (1.0 - ly.a)
        d = xl - xs
        take = _covers(ly, xl, ys) & (d > dR)
        dR = np.where(take, d, dR)
        kR = np.where(take, k, kR)
        xlR = np.where(take, xl, xlR)
    right = np.zeros((H, W), np.float32)
    for k, ly in enumerate(layers):
        m = kR == k
        if m.any():
            right[m] = _sample_row_linear(ly.texture, xlR)[m]

    # A left pixel is matched when the right view, at its partner
    # x - d, shows the same surface.
    xr = np.rint(xs - dL).astype(np.int32)
    inside = (xr >= 0) & (xr < W)
    rows = np.broadcast_to(np.arange(H)[:, None], (H, W))
    same = kR[rows, np.clip(xr, 0, W - 1)] == kL
    occluded = ~(inside & same)

    left += noise_sigma * rng.standard_normal((H, W)).astype(np.float32)
    right += noise_sigma * rng.standard_normal((H, W)).astype(np.float32)
    to_u8 = lambda im: np.clip(np.rint(im), 0, 255).astype(np.uint8)
    return StereoScene(to_u8(left), to_u8(right), dL.astype(np.float32), occluded)


def rectified_ground_truth(
    scene: StereoScene, K: np.ndarray, R1: np.ndarray, P1: np.ndarray,
    R2: np.ndarray, P2: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Ground truth in the rectified left view of a pair rectified with
    (R1, P1, R2, P2) from two undistorted cameras sharing K.

    Each rectified left pixel is traced back to the source left view
    (nearest pixel), its match (x - d, y) is carried through the right
    rectification, and the rectified disparity is the difference of the
    two rectified columns. Returns (disparity, known) where `known` marks
    pixels whose source is inside the frame and not occluded."""
    H, W = scene.disparity.shape
    K = np.asarray(K, np.float64)
    Kn1 = np.asarray(P1, np.float64)[:, :3]
    Kn2 = np.asarray(P2, np.float64)[:, :3]
    yn, xn = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([xn, yn, np.ones_like(xn)], -1) @ np.linalg.inv(Kn1).T
    src = (rays @ np.asarray(R1, np.float64)) @ K.T   # R1^T applied per row
    xs = src[..., 0] / src[..., 2]
    ys = src[..., 1] / src[..., 2]
    xi = np.rint(xs).astype(np.int64)
    yi = np.rint(ys).astype(np.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xi = np.clip(xi, 0, W - 1)
    yi = np.clip(yi, 0, H - 1)
    d_src = scene.disparity[yi, xi].astype(np.float64)
    known = inside & ~scene.occluded[yi, xi]
    # The partner in the right source view, through the right rectification.
    pr = np.stack([xs - d_src, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    pr = pr @ np.asarray(R2, np.float64).T @ Kn2.T
    x_right = pr[..., 0] / pr[..., 2]
    return (xn - x_right).astype(np.float32), known
