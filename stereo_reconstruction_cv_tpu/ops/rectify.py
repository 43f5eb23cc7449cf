"""Stereo rectification (Bouguet) and fused undistort-rectify-remap.

Replaces cv2.stereoRectify (reference gui.py:157, main.ipynb cell 3/7 —
golden Q output echoed in cell 8) and cv2.initUndistortRectifyMap +
cv2.remap (gui.py:160-164). The rectification transform itself is tiny
closed-form math (runs in f64 on host); the remap is the hot part: instead
of materializing two CV_32F map planes and gathering through them (three
full-image device-memory round trips), `rectify_remap` computes the inverse map on the
fly and bilinearly samples in one fused pass.

Conventions follow OpenCV: alpha=-1 -> default scaling; alpha in [0, 1]
blends the all-valid-pixels scale (alpha=1, the reference's setting) with
the no-black-pixels scale (alpha=0). Default flags = CALIB_ZERO_DISPARITY.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.ops import geometry as G


class RectifyResult(NamedTuple):
    R1: jnp.ndarray  # (3, 3) rectification rotation, camera 1
    R2: jnp.ndarray
    P1: jnp.ndarray  # (3, 4) rectified projection, camera 1
    P2: jnp.ndarray
    Q: jnp.ndarray   # (4, 4) disparity-to-depth reprojection


def _undistort_to_plane(
    pts: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray | None,
    R: jnp.ndarray | None = None, P: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """cv2.undistortPoints: pixels -> normalized (or re-projected through
    R, P when given). pts (N, 2)."""
    xy = jnp.stack(
        [(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]],
        axis=-1,
    )
    if dist is not None:
        xy = G.undistort_normalized(xy, dist, num_iters=20)
    if R is not None:
        v = G.to_homogeneous(xy) @ R.T
        xy = v[..., :2] / v[..., 2:3]
    if P is not None:
        xy = jnp.stack(
            [P[0, 0] * xy[..., 0] + P[0, 2], P[1, 1] * xy[..., 1] + P[1, 2]],
            axis=-1,
        )
    return xy


def _rectangles(
    K: jnp.ndarray, dist: jnp.ndarray | None, R: jnp.ndarray, P: jnp.ndarray,
    image_size: Tuple[int, int],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """OpenCV icvGetRectangles: sample a 9x9 pixel grid, undistort-rectify
    it, return (inner, outer) rectangles as (x0, y0, x1, y1)."""
    W, H = image_size
    N = 9
    gx = jnp.arange(N) * ((W - 1) / (N - 1))
    gy = jnp.arange(N) * ((H - 1) / (N - 1))
    pts = jnp.stack(jnp.meshgrid(gx, gy, indexing="xy"), axis=-1).reshape(-1, 2)
    q = _undistort_to_plane(pts, K, dist, R, P).reshape(N, N, 2)
    ox0, oy0 = jnp.min(q[..., 0]), jnp.min(q[..., 1])
    ox1, oy1 = jnp.max(q[..., 0]), jnp.max(q[..., 1])
    ix0 = jnp.max(q[:, 0, 0])
    ix1 = jnp.min(q[:, -1, 0])
    iy0 = jnp.max(q[0, :, 1])
    iy1 = jnp.min(q[-1, :, 1])
    return jnp.stack([ix0, iy0, ix1, iy1]), jnp.stack([ox0, oy0, ox1, oy1])


def stereo_rectify(
    K1: jnp.ndarray,
    dist1: jnp.ndarray | None,
    K2: jnp.ndarray,
    dist2: jnp.ndarray | None,
    image_size: Tuple[int, int],
    R: jnp.ndarray,
    T: jnp.ndarray,
    alpha: float = -1.0,
    zero_disparity: bool = True,
    new_image_size: Tuple[int, int] | None = None,
) -> RectifyResult:
    """Bouguet stereo rectification, cv2.stereoRectify parity.

    image_size is (width, height), OpenCV order. T is the cam1->cam2
    translation; R the relative rotation (x2 = R x1 + T).
    """
    W, H = image_size
    nW, nH = new_image_size if new_image_size is not None else image_size
    T = jnp.asarray(T).reshape(3)
    dt = T.dtype

    # Split the relative rotation evenly between the two cameras.
    om = G.matrix_to_rodrigues(R)
    r_r = G.rodrigues_to_matrix(om * -0.5)
    t = r_r @ T

    # Rotate the (averaged) baseline onto the x (horizontal) or y axis:
    # uu is the target axis signed like the dominant translation component,
    # ww = t x uu scaled to the misalignment angle (OpenCV's construction).
    idx = 0 if abs(float(t[0])) > abs(float(t[1])) else 1  # static choice
    c = t[idx]
    uu = jnp.zeros(3, dt).at[idx].set(jnp.where(c > 0, 1.0, -1.0))
    ww = jnp.cross(t, uu)
    nw = jnp.linalg.norm(ww)
    nt = jnp.linalg.norm(t)
    ang = jnp.arccos(jnp.abs(c) / nt)
    ww = jnp.where(nw > 0, ww * (ang / jnp.where(nw > 0, nw, 1.0)), ww)
    wR = G.rodrigues_to_matrix(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    ratio = (nW / W / 2.0) if idx == 1 else (nH / H / 2.0)
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    # New principal points: center the projected original corners. OpenCV
    # centers against the ORIGINAL size here ((W-1)/2, (H-1)/2); the
    # new-size ratio is applied only inside the alpha branch below —
    # applying it here too double-scales cc when new_image_size is set.
    corners = jnp.array(
        [[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 1.0, H - 1.0]], dt
    )
    cc = []
    for K, dist, Rk in ((K1, dist1, R1), (K2, dist2, R2)):
        n = _undistort_to_plane(corners, K, dist)
        v = G.to_homogeneous(n) @ Rk.T
        proj = fc_new * v[:, :2] / v[:, 2:3]
        avg = jnp.mean(proj, axis=0)
        cc.append(jnp.array([(W - 1) / 2, (H - 1) / 2], dt) - avg)
    cc1, cc2 = cc
    if zero_disparity:
        cc1 = cc2 = (cc1 + cc2) * 0.5
    elif idx == 0:
        m = (cc1[1] + cc2[1]) * 0.5
        cc1 = cc1.at[1].set(m)
        cc2 = cc2.at[1].set(m)
    else:
        m = (cc1[0] + cc2[0]) * 0.5
        cc1 = cc1.at[0].set(m)
        cc2 = cc2.at[0].set(m)

    def make_P(fc, c, tterm):
        P = jnp.zeros((3, 4), dt)
        P = P.at[0, 0].set(fc).at[1, 1].set(fc).at[2, 2].set(1.0)
        P = P.at[0, 2].set(c[0]).at[1, 2].set(c[1])
        if tterm is not None:
            P = P.at[idx, 3].set(tterm)
        return P

    # cc carries the new-size ratio exactly once: here for alpha < 0, or
    # inside the alpha branch (which starts from the unscaled cc) otherwise.
    scale_xy = jnp.array([nW / W, nH / H], dt)
    if alpha < 0:
        cc1 = cc1 * scale_xy
        cc2 = cc2 * scale_xy
    P1 = make_P(fc_new, cc1, None)
    P2 = make_P(fc_new, cc2, t[idx] * fc_new)

    # Alpha scaling: blend the inscribed (s0) and bounding (s1) rectangle
    # scales of both views (OpenCV's free-scaling parameter).
    if alpha >= 0:
        a = min(float(alpha), 1.0)
        inner1, outer1 = _rectangles(K1, dist1, R1, P1, image_size)
        inner2, outer2 = _rectangles(K2, dist2, R2, P2, image_size)
        cx1_0, cy1_0 = cc1[0], cc1[1]
        cx2_0, cy2_0 = cc2[0], cc2[1]
        cx1 = nW * cx1_0 / W
        cy1 = nH * cy1_0 / H
        cx2 = nW * cx2_0 / W
        cy2 = nH * cy2_0 / H

        def s_of(rect, cx_0, cy_0, cx, cy):
            x0, y0, x1, y1 = rect[0], rect[1], rect[2], rect[3]
            return jnp.stack(
                [
                    cx / (cx_0 - x0),
                    cy / (cy_0 - y0),
                    (nW - 1 - cx) / (x1 - cx_0),
                    (nH - 1 - cy) / (y1 - cy_0),
                ]
            )

        s0 = jnp.maximum(
            jnp.max(s_of(inner1, cx1_0, cy1_0, cx1, cy1)),
            jnp.max(s_of(inner2, cx2_0, cy2_0, cx2, cy2)),
        )
        s1 = jnp.minimum(
            jnp.min(s_of(outer1, cx1_0, cy1_0, cx1, cy1)),
            jnp.min(s_of(outer2, cx2_0, cy2_0, cx2, cy2)),
        )
        s = s0 * (1.0 - a) + s1 * a
        fc_new = fc_new * s
        cc1 = jnp.array([cx1, cy1], dt)
        cc2 = jnp.array([cx2, cy2], dt)
        P1 = make_P(fc_new, cc1, None)
        P2 = make_P(fc_new, cc2, t[idx] * fc_new)

    Q = jnp.array(
        [
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
        ],
        dt,
    )
    Q = Q.at[0, 3].set(-cc1[0]).at[1, 3].set(-cc1[1]).at[2, 3].set(fc_new)
    Q = Q.at[3, 2].set(-1.0 / t[idx]).at[3, 3].set((cc1[0] - cc2[0]) / t[idx])
    return RectifyResult(R1, R2, P1, P2, Q)


# ---------------------------------------------------------------------------
# Fused undistort-rectify-remap
# ---------------------------------------------------------------------------

def rectify_map(
    K: jnp.ndarray,
    dist: jnp.ndarray | None,
    R: jnp.ndarray,
    P: jnp.ndarray,
    out_size: Tuple[int, int],
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Inverse rectification map (cv2.initUndistortRectifyMap CV_32FC2):
    for each destination pixel, the source pixel to sample. -> (H, W, 2)."""
    W, H = out_size
    u = jax.lax.broadcasted_iota(dtype, (H, W), 1)
    v = jax.lax.broadcasted_iota(dtype, (H, W), 0)
    x = (u - P[0, 2].astype(dtype)) / P[0, 0].astype(dtype)
    y = (v - P[1, 2].astype(dtype)) / P[1, 1].astype(dtype)
    # Invert in the compute dtype (f32 on the device path).
    Rinv = jnp.linalg.inv(R.astype(dtype))
    X = Rinv[0, 0] * x + Rinv[0, 1] * y + Rinv[0, 2]
    Y = Rinv[1, 0] * x + Rinv[1, 1] * y + Rinv[1, 2]
    Wc = Rinv[2, 0] * x + Rinv[2, 1] * y + Rinv[2, 2]
    xn = X / Wc
    yn = Y / Wc
    if dist is not None:
        d = G.distort_normalized(jnp.stack([xn, yn], axis=-1), dist.astype(dtype))
        xn, yn = d[..., 0], d[..., 1]
    K = K.astype(dtype)
    src_x = K[0, 0] * xn + K[0, 2]
    src_y = K[1, 1] * yn + K[1, 2]
    return jnp.stack([src_x, src_y], axis=-1)


def _affine_params(K, dist, R, P, out_size):
    """(sy, ty, sx, tx) as python floats when the rectification map is
    EXACTLY separable-affine (dist None, R == I: then xn = x and
    src_x = K00/P00 * u + (K02 - K00*P02/P00), independent of v — see
    rectify_map), else None. Only decidable when the geometry arguments
    are concrete (they are closure constants in the usual jit pattern;
    the image alone is traced)."""
    import numpy as np

    if dist is not None:
        return None
    for a in (K, R, P):
        if isinstance(a, jax.core.Tracer):
            return None
    Rn = np.asarray(R, np.float64)
    if not np.allclose(Rn, np.eye(3), atol=1e-9):
        return None
    Kn = np.asarray(K, np.float64)
    Pn = np.asarray(P, np.float64)
    sx = Kn[0, 0] / Pn[0, 0]
    tx = Kn[0, 2] - sx * Pn[0, 2]
    sy = Kn[1, 1] / Pn[1, 1]
    ty = Kn[1, 2] - sy * Pn[1, 2]
    if Kn[0, 1] != 0.0:  # skew couples axes
        return None
    return float(sy), float(ty), float(sx), float(tx)


def _affine_resample(img: jnp.ndarray, params, out_size) -> jnp.ndarray:
    """Exact separable bilinear resample of an affine map as two banded
    matmuls: out = Wy @ img @ Wx^T with 2-banded weight rows built from
    iota compares, at HIGHEST precision (no reduced-precision matmul may
    round the taps). Tap masking matches cv2 BORDER_CONSTANT=0 exactly —
    an out-of-range tap simply matches no weight column."""
    sy, ty, sx, tx = params
    Wo, Ho = out_size
    H, W = img.shape

    def weights(n_out, n_in, s, t):
        o = jnp.arange(n_out, dtype=jnp.float32)
        src = s * o + t
        b0 = jnp.floor(src)
        f = (src - b0)[:, None]
        ii = jax.lax.broadcasted_iota(jnp.float32, (n_out, n_in), 1)
        b0 = b0[:, None]
        return jnp.where(ii == b0, 1.0 - f, 0.0) + jnp.where(ii == b0 + 1.0, f, 0.0)

    Wy = weights(Ho, H, sy, ty)
    Wx = weights(Wo, W, sx, tx)
    acc = jax.lax.dot(
        jax.lax.dot(Wy, img.astype(jnp.float32),
                    precision=jax.lax.Precision.HIGHEST),
        Wx.T, precision=jax.lax.Precision.HIGHEST)
    if jnp.issubdtype(img.dtype, jnp.integer):
        return jnp.round(acc).astype(img.dtype)
    return acc.astype(img.dtype)


def remap_bilinear(img: jnp.ndarray, src_map: jnp.ndarray) -> jnp.ndarray:
    """Bilinear resample (cv2.remap INTER_LINEAR, BORDER_CONSTANT=0).

    img (H, W) or (H, W, C); map (Ho, Wo, 2) of source (x, y). Out-of-range
    samples are 0, matching cv2's default border.

    uint8 single-plane images take the packed-gather path: the 2x2
    bilinear neighborhood is packed into one uint32 per source pixel
    (zero-padded one-ring), so the resample is ONE gather instead of four.
    Other dtypes use the generic four-tap path below."""
    if img.dtype == jnp.uint8 and img.ndim == 2:
        return _remap_bilinear_packed_u8(img, src_map)
    H, W = img.shape[:2]
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = jnp.clip(xi, 0, W - 1)
        yi = jnp.clip(yi, 0, H - 1)
        val = img[yi, xi]
        if img.ndim == 3:
            return jnp.where(inb[..., None], val, 0)
        return jnp.where(inb, val, 0)

    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    if img.ndim == 3:
        w00, w10, w01, w11 = (w[..., None] for w in (w00, w10, w01, w11))
    acc = (
        tap(x0i, y0i).astype(jnp.float32) * w00
        + tap(x0i + 1, y0i).astype(jnp.float32) * w10
        + tap(x0i, y0i + 1).astype(jnp.float32) * w01
        + tap(x0i + 1, y0i + 1).astype(jnp.float32) * w11
    )
    if jnp.issubdtype(img.dtype, jnp.integer):
        return jnp.round(acc).astype(img.dtype)
    return acc.astype(img.dtype)


def _remap_bilinear_packed_u8(img: jnp.ndarray, src_map: jnp.ndarray) -> jnp.ndarray:
    """One-gather bilinear resample for (H, W) uint8.

    P = img zero-padded by one ring; Q[i, j] packs the 2x2 block
    P[i:i+2, j:j+2] into a uint32. For base tap (x0, y0), Q[y0+1, x0+1]
    holds all four taps with cv2's BORDER_CONSTANT=0 already applied by
    the padding; bases outside [-1, W-1] x [-1, H-1] have all taps
    out-of-range and are masked to 0 wholesale. Bit-identical to the
    generic four-tap path (tests/test_rectify.py)."""
    H, W = img.shape
    P = jnp.pad(img.astype(jnp.uint32), 1)
    Q = (
        P[:-1, :-1]
        | (P[:-1, 1:] << 8)
        | (P[1:, :-1] << 16)
        | (P[1:, 1:] << 24)
    )  # (H+1, W+1)
    x = src_map[..., 0]
    y = src_map[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    allin = (x0i >= -1) & (x0i <= W - 1) & (y0i >= -1) & (y0i <= H - 1)
    qx = jnp.clip(x0i + 1, 0, W)
    qy = jnp.clip(y0i + 1, 0, H)
    packed = jnp.take(Q.ravel(), qy * (W + 1) + qx)
    t00 = (packed & 0xFF).astype(jnp.float32)
    t10 = ((packed >> 8) & 0xFF).astype(jnp.float32)
    t01 = ((packed >> 16) & 0xFF).astype(jnp.float32)
    t11 = ((packed >> 24) & 0xFF).astype(jnp.float32)
    acc = (
        t00 * (1 - fx) * (1 - fy)
        + t10 * fx * (1 - fy)
        + t01 * (1 - fx) * fy
        + t11 * fx * fy
    )
    acc = jnp.where(allin, acc, 0.0)
    return jnp.round(acc).astype(jnp.uint8)


def rectify_remap(
    img: jnp.ndarray,
    K: jnp.ndarray,
    dist: jnp.ndarray | None,
    R: jnp.ndarray,
    P: jnp.ndarray,
    out_size: Tuple[int, int] | None = None,
) -> jnp.ndarray:
    """Fused map generation + bilinear sample: one pass over the image, no
    materialized CV_32F map planes (SURVEY §2.3 remap row). jit-compatible;
    vmap a leading batch axis for batched pairs.

    When the map is exactly separable-affine (identity rectification
    rotation, no distortion — the pre-aligned-rig case and BASELINE
    config 3's calibrated geometry) and the geometry is concrete, the
    resample runs as two banded matmuls (_affine_resample)."""
    if out_size is None:
        out_size = (img.shape[1], img.shape[0])
    if img.ndim == 2:
        params = _affine_params(K, dist, R, P, out_size)
        if params is not None:
            return _affine_resample(img, params, out_size)
    m = rectify_map(K, dist, R, P, out_size)
    return remap_bilinear(img, m)
