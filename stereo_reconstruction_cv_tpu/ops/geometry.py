"""Core camera & epipolar geometry — pure jnp, batched/vmappable, no I/O.

Device replacements for the reference's small native kernels
(SURVEY.md §2.3): cv2.Rodrigues, cv2.projectPoints (gui.py:70),
cv2.computeCorrespondEpilines (gui.py:148-153), cv2.triangulatePoints
(README.md:29 [branch]), cv2.reprojectImageTo3D (main.ipynb cell 11).

Conventions match OpenCV: points are (x, y) = (col, row); K is the 3x3
upper-triangular intrinsic matrix; distortion is the 5-vector
(k1, k2, p1, p2, k3). All functions preserve the dtype of their inputs
(float64 for calibration-grade accuracy on host, float32 on the device).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Homogeneous coordinates
# ---------------------------------------------------------------------------

def to_homogeneous(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., D) -> (..., D+1) with a trailing 1."""
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)


def from_homogeneous(pts: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """(..., D+1) -> (..., D), dividing by the last coordinate."""
    w = pts[..., -1:]
    if eps:
        w = jnp.where(jnp.abs(w) < eps, jnp.sign(w) * eps + (w == 0) * eps, w)
    return pts[..., :-1] / w


# ---------------------------------------------------------------------------
# Rotations (cv2.Rodrigues parity)
# ---------------------------------------------------------------------------

def rodrigues_to_matrix(rvec: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle (3,) -> rotation matrix (3, 3). Matches cv2.Rodrigues.

    Safe at theta ~ 0 via the series expansion of sinc terms.
    """
    rvec = jnp.asarray(rvec).reshape(3)
    theta2 = jnp.dot(rvec, rvec)
    theta = jnp.sqrt(theta2)
    # sinc(theta) and (1-cos)/theta^2 with small-angle series fallbacks.
    small = theta2 < 1e-16
    s = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    c1 = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    kx, ky, kz = rvec[0], rvec[1], rvec[2]
    K = jnp.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]], dtype=rvec.dtype)
    eye = jnp.eye(3, dtype=rvec.dtype)
    return eye + s * K + c1 * (K @ K)


def matrix_to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (3, 3) -> unit quaternion (w, x, y, z), w >= 0.

    Shepperd's method: pick the numerically largest of the four pivots
    (branchless via where-selects), robust for all angles including ~pi.
    """
    R = jnp.asarray(R)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22
    q0 = jnp.stack([t0, m21 - m12, m02 - m20, m10 - m01])
    q1 = jnp.stack([m21 - m12, t1, m01 + m10, m02 + m20])
    q2 = jnp.stack([m02 - m20, m01 + m10, t2, m12 + m21])
    q3 = jnp.stack([m10 - m01, m20 + m02, m12 + m21, t3])
    ts = jnp.stack([t0, t1, t2, t3])
    qs = jnp.stack([q0, q1, q2, q3])  # (4, 4)
    i = jnp.argmax(ts)
    q = qs[i] * (0.5 / jnp.sqrt(jnp.clip(ts[i], 1e-30)))
    q = q / jnp.linalg.norm(q)
    return q * jnp.where(q[0] < 0, -1.0, 1.0)


def matrix_to_rodrigues(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (3, 3) -> axis-angle (3,). Matches cv2.Rodrigues."""
    q = matrix_to_quaternion(R)
    w, v = q[0], q[1:]
    vn = jnp.linalg.norm(v)
    theta = 2.0 * jnp.arctan2(vn, w)
    axis = v / jnp.where(vn < 1e-30, 1.0, vn)
    return jnp.where(vn < 1e-30, jnp.zeros(3, q.dtype), axis * theta)


# ---------------------------------------------------------------------------
# Pinhole projection with 5-coefficient distortion (cv2.projectPoints parity)
# ---------------------------------------------------------------------------

def distort_normalized(xy: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Apply (k1,k2,p1,p2,k3) distortion to normalized coords (..., 2)."""
    dist = jnp.asarray(dist).reshape(-1)
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if dist.shape[0] > 4 else jnp.zeros((), dist.dtype)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + p2 * xy2
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(
    xy_dist: jnp.ndarray, dist: jnp.ndarray, num_iters: int = 10
) -> jnp.ndarray:
    """Invert the 5-coeff distortion by fixed-point iteration (cv2.undistortPoints).

    Fixed iteration count keeps the op jit friendly (no dynamic loops).
    """
    xy = xy_dist
    for _ in range(num_iters):
        xy = xy - (distort_normalized(xy, dist) - xy_dist)
    return xy


def project_points(
    object_points: jnp.ndarray,
    rvec: jnp.ndarray,
    tvec: jnp.ndarray,
    K: jnp.ndarray,
    dist: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Project 3D points (N, 3) to pixels (N, 2). Matches cv2.projectPoints.

    Used for calibration reprojection error (reference gui.py:69-73).
    vmap over the leading axis of (rvec, tvec) for per-view batching.
    """
    R = rodrigues_to_matrix(rvec)
    cam = object_points @ R.T + jnp.asarray(tvec).reshape(1, 3)
    xy = cam[..., :2] / cam[..., 2:3]
    if dist is not None:
        xy = distort_normalized(xy, dist)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    u = fx * xy[..., 0] + skew * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return jnp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# Epipolar geometry helpers
# ---------------------------------------------------------------------------

def compute_epilines(pts: jnp.ndarray, F: jnp.ndarray, which_image: int) -> jnp.ndarray:
    """Epipolar lines for points (N, 2). Matches cv2.computeCorrespondEpilines.

    which_image=1: pts are in image 1, lines are in image 2 (l = F x).
    which_image=2: pts are in image 2, lines are in image 1 (l = F^T x).
    Lines are normalized so a^2 + b^2 = 1.
    """
    x = to_homogeneous(pts)
    lines = x @ (F.T if which_image == 1 else F)
    nrm = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    nrm = jnp.where(nrm == 0, 1.0, nrm)
    return lines / nrm[..., None]


def epipolar_distance(F: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray) -> jnp.ndarray:
    """Symmetric point-to-epiline distance per correspondence (N,)."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    l2 = x1 @ F.T  # lines in image 2
    l1 = x2 @ F    # lines in image 1
    num = jnp.abs(jnp.sum(x2 * l2, axis=-1))
    d2 = num / jnp.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-30)
    d1 = num / jnp.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-30)
    return 0.5 * (d1 + d2)


def sampson_error(F: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) error per correspondence (N,)."""
    x1 = to_homogeneous(pts1)
    x2 = to_homogeneous(pts2)
    Fx1 = x1 @ F.T
    Ftx2 = x2 @ F
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / (den + 1e-30)


# ---------------------------------------------------------------------------
# Triangulation (cv2.triangulatePoints parity)
# ---------------------------------------------------------------------------

def triangulate_points(
    P1: jnp.ndarray, P2: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray
) -> jnp.ndarray:
    """DLT triangulation. P1, P2: (3, 4); pts: (N, 2). Returns homogeneous (N, 4).

    Matches cv2.triangulatePoints (up to per-point scale: the returned vectors
    are unit-norm right-singular vectors). Batched: one 4x4 SVD per point via
    vmap — an embarrassingly parallel solve.
    """

    def one(p1, p2):
        A = jnp.stack(
            [
                p1[0] * P1[2] - P1[0],
                p1[1] * P1[2] - P1[1],
                p2[0] * P2[2] - P2[0],
                p2[1] * P2[2] - P2[1],
            ]
        )
        # Smallest right singular vector of A (4x4) == null vector of
        # A^T A: inverse iteration (ops/linalg.py), no SVD lowering.
        from stereo_reconstruction_cv_tpu.ops import linalg as LA

        return LA.smallest_eigvec(A.T @ A, iters=6)

    return jax.vmap(one)(pts1, pts2)


def triangulate_to_3d(
    P1: jnp.ndarray, P2: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray
) -> jnp.ndarray:
    """Triangulate and dehomogenize -> (N, 3)."""
    Xh = triangulate_points(P1, P2, pts1, pts2)
    return from_homogeneous(Xh, eps=1e-30)


# ---------------------------------------------------------------------------
# Disparity -> 3D (cv2.reprojectImageTo3D parity)
# ---------------------------------------------------------------------------

def reproject_image_to_3d(disparity: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel homogeneous reprojection: (H, W) disparity -> (H, W, 3).

    [X Y Z W]^T = Q @ [x y d 1]^T with x=column, y=row; output (X, Y, Z)/W.
    Matches cv2.reprojectImageTo3D with handleMissingValues=False
    (reference main.ipynb cell 11). Pure elementwise math -> fuses into one
    XLA kernel; vmap over a leading batch axis for multi-pair batches.
    """
    H, W = disparity.shape
    dt = disparity.dtype
    y = jax.lax.broadcasted_iota(dt, (H, W), 0)
    x = jax.lax.broadcasted_iota(dt, (H, W), 1)
    ones = jnp.ones((H, W), dt)
    v = jnp.stack([x, y, disparity, ones], axis=-1)  # (H, W, 4)
    out = v @ Q.astype(dt).T
    w = out[..., 3:4]
    w = jnp.where(w == 0, jnp.asarray(jnp.inf, dt), w)
    return out[..., :3] / w


def valid_point_mask(points_3d: jnp.ndarray, disparity: jnp.ndarray) -> jnp.ndarray:
    """Validity mask used by the reference viewer (main.ipynb cell 12 +17-21):
    finite 3D coordinates and strictly positive disparity."""
    finite = jnp.all(jnp.isfinite(points_3d), axis=-1)
    return finite & (disparity > 0)
