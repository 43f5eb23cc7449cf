"""Two-camera (stereo) calibration from synchronized chessboard pairs.

The reference's stereo-camera branch calibrates both cameras and their
relative pose from simultaneously captured chessboard views
(README.md:59-76 [branch]: per-camera K plus stereo extrinsics — the
cv2.stereoCalibrate workflow). Batched design: both cameras' intrinsics
initialize from single-camera Zhang solves, the relative pose from the
per-view pose pairs (R = R2 R1^T medoid), and one joint LM refines
[K1, dist1, K2, dist2, R, T, per-view (rvec, tvec) of camera 1] against
reprojection in both images simultaneously — a single compiled program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.calib import zhang as Z
from stereo_reconstruction_cv_tpu.ops import geometry as G


class StereoCalibrationResult(NamedTuple):
    K1: jnp.ndarray
    dist1: jnp.ndarray
    K2: jnp.ndarray
    dist2: jnp.ndarray
    R: jnp.ndarray        # cam1 -> cam2 rotation (x2 = R x1 + T)
    T: jnp.ndarray        # cam1 -> cam2 translation
    rvecs: jnp.ndarray    # (V, 3) board pose in camera 1
    tvecs: jnp.ndarray
    rms: jnp.ndarray


def _pack(K1, d1, K2, d2, rT, tT, rvecs, tvecs):
    return jnp.concatenate([
        jnp.array([K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2]]), d1,
        jnp.array([K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]]), d2,
        rT, tT, rvecs.ravel(), tvecs.ravel(),
    ])


def _unpack(theta, V):
    def K_of(v):
        return jnp.array([[v[0], 0.0, v[2]], [0.0, v[1], v[3]], [0.0, 0.0, 1.0]])

    K1 = K_of(theta[0:4])
    d1 = theta[4:9]
    K2 = K_of(theta[9:13])
    d2 = theta[13:18]
    rT = theta[18:21]
    tT = theta[21:24]
    rvecs = theta[24 : 24 + 3 * V].reshape(V, 3)
    tvecs = theta[24 + 3 * V :].reshape(V, 3)
    return K1, d1, K2, d2, rT, tT, rvecs, tvecs


def _residuals(theta, obj, img1, img2):
    V = img1.shape[0]
    K1, d1, K2, d2, rT, tT, rvecs, tvecs = _unpack(theta, V)
    Rrel = G.rodrigues_to_matrix(rT)

    def per_view(rv, tv, i1, i2):
        p1 = G.project_points(obj, rv, tv, K1, d1)
        # board -> cam2: compose with the stereo extrinsics.
        R1 = G.rodrigues_to_matrix(rv)
        R2 = Rrel @ R1
        t2 = Rrel @ tv + tT
        rv2 = G.matrix_to_rodrigues(R2)
        p2 = G.project_points(obj, rv2, t2, K2, d2)
        return jnp.concatenate([(p1 - i1).ravel(), (p2 - i2).ravel()])

    return jax.vmap(per_view)(rvecs, tvecs, img1, img2).ravel()


def calibrate_stereo(
    obj_pts: jnp.ndarray,
    img_pts1: jnp.ndarray,
    img_pts2: jnp.ndarray,
    image_size: Tuple[int, int],
    max_iters: int = 40,
) -> StereoCalibrationResult:
    """Joint stereo calibration. obj_pts (N, 3); img_pts{1,2} (V, N, 2)."""
    obj_pts = jnp.asarray(obj_pts)
    img_pts1 = jnp.asarray(img_pts1)
    img_pts2 = jnp.asarray(img_pts2)
    V = img_pts1.shape[0]

    # Per-camera init (batched Zhang + LM).
    c1 = Z.calibrate_camera(obj_pts, img_pts1, image_size, max_iters=20)
    c2 = Z.calibrate_camera(obj_pts, img_pts2, image_size, max_iters=20)

    # Relative pose per view: R_rel^v = R2_v R1_v^T; init from the view
    # whose pair reprojects best (a medoid would also do).
    def rel(rv1, tv1, rv2, tv2):
        R1 = G.rodrigues_to_matrix(rv1)
        R2 = G.rodrigues_to_matrix(rv2)
        Rr = R2 @ R1.T
        Tr = tv2 - Rr @ tv1
        return G.matrix_to_rodrigues(Rr), Tr

    rels = jax.vmap(rel)(c1.rvecs, c1.tvecs, c2.rvecs, c2.tvecs)
    # Use the per-view medians as a robust initializer.
    rT0 = jnp.median(rels[0], axis=0)
    tT0 = jnp.median(rels[1], axis=0)

    theta0 = _pack(c1.K, c1.dist, c2.K, c2.dist, rT0, tT0, c1.rvecs, c1.tvecs)
    res_fn = lambda th: _residuals(th, obj_pts, img_pts1, img_pts2)

    def lm_step(state, _):
        theta, lam, prev_cost = state
        r = res_fn(theta)
        J = jax.jacfwd(res_fn)(theta)
        A = J.T @ J + lam * jnp.diag(jnp.diag(J.T @ J) + 1e-12)
        delta = jnp.linalg.solve(A, -(J.T @ r))
        theta_new = theta + delta
        new_cost = jnp.sum(res_fn(theta_new) ** 2)
        accept = new_cost < prev_cost
        theta = jnp.where(accept, theta_new, theta)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return (theta, lam, jnp.where(accept, new_cost, prev_cost)), None

    cost0 = jnp.sum(res_fn(theta0) ** 2)
    (theta, _, _), _ = jax.lax.scan(
        lm_step, (theta0, jnp.asarray(1e-3, obj_pts.dtype), cost0), None,
        length=max_iters,
    )
    K1, d1, K2, d2, rT, tT, rvecs, tvecs = _unpack(theta, V)
    r = res_fn(theta)
    rms = jnp.sqrt(jnp.mean(jnp.sum(r.reshape(-1, 2) ** 2, axis=-1)))
    return StereoCalibrationResult(
        K1, d1, K2, d2, G.rodrigues_to_matrix(rT), tT, rvecs, tvecs, rms
    )
