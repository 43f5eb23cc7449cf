"""Two-view epipolar solvers: 8-point F/E, decomposition, pose recovery.

Device replacements for cv2.findFundamentalMat / cv2.findEssentialMat /
cv2.recoverPose (reference gui.py:135, 142, 145, 313, 316; main.ipynb cell 6).
All solvers are weighted (a weight/mask vector makes shapes static for jit)
and vmappable so the robust engine can run hundreds of minimal solves as one
batched eigendecomposition.

Numerics: all solves run through Hartley normalization — raw 4K pixel
coordinates cancel catastrophically in float32, normalized
coordinates are well conditioned in either precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.ops import geometry as G
from stereo_reconstruction_cv_tpu.ops import linalg as LA


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def normalize_points(pts: jnp.ndarray, weights: jnp.ndarray | None = None):
    """Hartley normalization: translate centroid to origin, scale mean
    distance to sqrt(2). Returns (pts_normalized (N,2), T (3,3)) with
    x_n = T @ x_h. Weighted so masked points don't move the frame."""
    if weights is None:
        weights = jnp.ones(pts.shape[:-1], pts.dtype)
    wsum = jnp.sum(weights) + 1e-30
    centroid = jnp.sum(pts * weights[..., None], axis=0) / wsum
    d = pts - centroid
    mean_dist = jnp.sum(jnp.linalg.norm(d, axis=-1) * weights) / wsum
    scale = jnp.sqrt(2.0).astype(pts.dtype) / (mean_dist + 1e-30)
    T = jnp.array(
        [
            [scale, 0.0, -scale * centroid[0]],
            [0.0, scale, -scale * centroid[1]],
            [0.0, 0.0, 1.0],
        ],
        dtype=pts.dtype,
    )
    return d * scale, T


# ---------------------------------------------------------------------------
# 8-point algorithm (weighted, batched-friendly)
# ---------------------------------------------------------------------------

def _smallest_eigvec_9(ATA: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a symmetric 9x9.

    Inverse iteration (ops/linalg.py), not jnp.linalg.eigh: a general
    batched eigh is overkill for a null-vector extraction."""
    return LA.smallest_eigvec(ATA, iters=8)


def eight_point(
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    enforce_rank2: bool = True,
) -> jnp.ndarray:
    """Weighted normalized 8-point estimate of F with x2^T F x1 = 0.

    pts: (N, 2) pixel coords, N >= 8. weights: (N,) soft mask.
    Returns F (3, 3) scaled so F[2, 2] = 1 where possible (cv2 convention).
    """
    if weights is None:
        weights = jnp.ones(pts1.shape[:-1], pts1.dtype)
    p1n, T1 = normalize_points(pts1, weights)
    p2n, T2 = normalize_points(pts2, weights)
    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1)
    Aw = A * weights[:, None]
    f = _smallest_eigvec_9(Aw.T @ A)  # (A^T W A) f = min
    F = f.reshape(3, 3)
    if enforce_rank2:
        u, s, vt = LA.svd3(F)
        F = (u * s.at[2].set(0.0)[None, :]) @ vt
    F = T2.T @ F @ T1
    den = F[2, 2]
    return F / jnp.where(jnp.abs(den) < 1e-12, jnp.sign(den) + (den == 0), den)


def essential_8pt(
    npts1: jnp.ndarray,
    npts2: jnp.ndarray,
    weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """8-point E on *K-normalized* coordinates, projected onto the essential
    manifold (two equal singular values, third zero). Returns unit-norm E."""
    if weights is None:
        weights = jnp.ones(npts1.shape[:-1], npts1.dtype)
    p1n, T1 = normalize_points(npts1, weights)
    p2n, T2 = normalize_points(npts2, weights)
    x1, y1 = p1n[:, 0], p1n[:, 1]
    x2, y2 = p2n[:, 0], p2n[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1)
    Aw = A * weights[:, None]
    e = _smallest_eigvec_9(Aw.T @ A)
    E = T2.T @ e.reshape(3, 3) @ T1
    u, s, vt = LA.svd3(E)
    sm = (s[0] + s[1]) * 0.5
    E = (u * jnp.array([sm, sm, 0.0], E.dtype)[None, :]) @ vt
    return E / (jnp.linalg.norm(E) + 1e-30)


# ---------------------------------------------------------------------------
# Essential matrix utilities
# ---------------------------------------------------------------------------

def skew(t: jnp.ndarray) -> jnp.ndarray:
    tx, ty, tz = t[0], t[1], t[2]
    z = jnp.zeros((), t.dtype)
    return jnp.array([[z, -tz, ty], [tz, z, -tx], [-ty, tx, z]])


def essential_from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """E = [t]_x R for x2 = R x1 + t (cv2 convention)."""
    return skew(t) @ R


def essential_from_fundamental(F: jnp.ndarray, K1: jnp.ndarray, K2: jnp.ndarray) -> jnp.ndarray:
    E = K2.T @ F @ K1
    u, s, vt = LA.svd3(E)
    sm = (s[0] + s[1]) * 0.5
    return (u * jnp.array([sm, sm, 0.0], E.dtype)[None, :]) @ vt


def fundamental_from_essential(E: jnp.ndarray, K1: jnp.ndarray, K2: jnp.ndarray) -> jnp.ndarray:
    return LA.inv3(K2).T @ E @ LA.inv3(K1)


def decompose_essential(E: jnp.ndarray):
    """E -> (R1, R2, t) candidate decomposition (cv2.decomposeEssentialMat).

    The four pose candidates are (R1, t), (R1, -t), (R2, t), (R2, -t).
    """
    u, _, vt = LA.svd3(E)
    # Force proper rotations.
    u = u * jnp.sign(LA.det3(u))
    vt = vt * jnp.sign(LA.det3(vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    return R1, R2, t


def _cheirality_count(R, t, npts1, npts2, weights):
    """Number of (weighted) correspondences with positive depth in both
    cameras for pose x2 = R x1 + t, using midpoint-free linear triangulation
    in normalized camera coordinates."""
    P2 = jnp.concatenate([R, t[:, None]], axis=1)  # (3,4)
    # Triangulate with P1 = [I|0]: DLT rows; solve 4x4 per point via eigh.
    x1 = G.to_homogeneous(npts1)  # (N,3)
    x2 = G.to_homogeneous(npts2)

    def one(p1, p2):
        P1r = jnp.eye(3, 4, dtype=R.dtype)
        A = jnp.stack(
            [
                p1[0] * P1r[2] - P1r[0],
                p1[1] * P1r[2] - P1r[1],
                p2[0] * P2[2] - P2[0],
                p2[1] * P2[2] - P2[1],
            ]
        )
        X = LA.smallest_eigvec(A.T @ A, iters=6)
        X = X / jnp.where(jnp.abs(X[3]) < 1e-30, 1e-30, X[3])
        z1 = X[2]
        z2 = P2[2] @ X
        return (z1 > 0) & (z2 > 0) & (jnp.abs(X[2]) < 1e9)

    ok = jax.vmap(one)(npts1, npts2)
    return jnp.sum(ok * weights), ok


def recover_pose(
    E: jnp.ndarray,
    npts1: jnp.ndarray,
    npts2: jnp.ndarray,
    weights: jnp.ndarray | None = None,
):
    """Choose the (R, t) with the best cheirality vote. cv2.recoverPose parity.

    npts are K-normalized image coordinates. Returns (R, t, good_mask, votes).
    t is unit-norm (scale is unobservable — this is the quirk the reference
    hits when its user-supplied baseline is overwritten, gui.py:108 vs :145).
    """
    if weights is None:
        weights = jnp.ones(npts1.shape[:-1], npts1.dtype)
    R1, R2, t = decompose_essential(E)
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    counts, masks = [], []
    for R_, t_ in cands:
        c, m = _cheirality_count(R_, t_, npts1, npts2, weights)
        counts.append(c)
        masks.append(m)
    counts = jnp.stack(counts)
    masks = jnp.stack(masks)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    best = jnp.argmax(counts)
    return Rs[best], ts[best], masks[best] & (weights > 0), counts[best]


def pixel_to_normalized(pts: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray | None = None) -> jnp.ndarray:
    """Pixel -> K-normalized coordinates, optionally undistorting."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xy = jnp.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], axis=-1)
    if dist is not None:
        xy = G.undistort_normalized(xy, dist)
    return xy
