"""5-point essential solver: minimal-solve exactness, planar recovery.

The planar case is the reason the solver exists: the
8-point algorithm is degenerate when all points are coplanar, while
Nistér's 5-point is not. cv2.findEssentialMat is 5-point (reference
gui.py:142)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_reconstruction_cv_tpu.ops import epipolar as EP
from stereo_reconstruction_cv_tpu.ops import robust as RB
from stereo_reconstruction_cv_tpu.ops.fivepoint import essential_5pt


def _rodrigues(v):
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _project(X, R, t):
    """3D world points -> normalized image coords of both cameras
    (x2 = R x1 + t convention)."""
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T + t[None]
    return x1, X2[:, :2] / X2[:, 2:3]


# Realistic camera for the robust-path tests: the RANSAC threshold is
# 1 px / f, so pixel-domain inputs exercise the true inlier geometry.
_K = np.array([[1000.0, 0.0, 640.0], [0.0, 1000.0, 360.0], [0.0, 0.0, 1.0]])


def _to_px(xn):
    return xn * 1000.0 + np.array([640.0, 360.0])


def _e_err(E, E_true):
    E = np.asarray(E) / np.linalg.norm(np.asarray(E))
    return min(np.abs(E - E_true).max(), np.abs(E + E_true).max())


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 3])
def test_minimal_exact(rng, seed):
    """A noise-free 5-point sample reproduces E among the real roots."""
    r = np.random.default_rng(seed)
    R = _rodrigues(r.standard_normal(3) * 0.25)
    t = r.standard_normal(3)
    t /= np.linalg.norm(t)
    E_true = np.array(EP.essential_from_Rt(jnp.asarray(R), jnp.asarray(t)))
    E_true /= np.linalg.norm(E_true)
    X = r.uniform(-1, 1, (5, 3))
    X[:, 2] = r.uniform(3, 6, 5)
    x1, x2 = _project(X, R, t)
    Ecand, valid = jax.jit(essential_5pt)(jnp.asarray(x1), jnp.asarray(x2))
    errs = [_e_err(E, E_true) for E, v in zip(np.asarray(Ecand), np.asarray(valid)) if v]
    assert errs and min(errs) < 1e-6


def test_minimal_exact_f32():
    """The solver holds up in float32 (the device execution dtype)."""
    r = np.random.default_rng(1)
    R = _rodrigues(r.standard_normal(3) * 0.2)
    t = r.standard_normal(3)
    t /= np.linalg.norm(t)
    E_true = np.array(EP.essential_from_Rt(jnp.asarray(R), jnp.asarray(t)))
    E_true /= np.linalg.norm(E_true)
    X = r.uniform(-1, 1, (5, 3))
    X[:, 2] = r.uniform(3, 6, 5)
    x1, x2 = _project(X, R, t)
    # Jitted: ~16 s compile lands in the persistent cache (conftest), so
    # repeat runs skip straight to the ~4 ms execution; eager re-pays
    # ~16 s of op-by-op dispatch every run.
    Ecand, valid = jax.jit(essential_5pt)(
        jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)
    )
    errs = [_e_err(E, E_true) for E, v in zip(np.asarray(Ecand), np.asarray(valid)) if v]
    assert errs and min(errs) < 5e-3


def _planar_scene(r, n=60, noise=0.0):
    """All world points on one plane — the 8-point degeneracy."""
    R = _rodrigues(np.array([0.03, -0.2, 0.05]))
    t = np.array([1.0, 0.15, -0.1])
    t /= np.linalg.norm(t)
    u = r.uniform(-1.5, 1.5, (n, 2))
    # Plane: X = p0 + u1*a + u2*b
    a = np.array([1.0, 0.1, 0.2])
    b = np.array([-0.1, 1.0, 0.15])
    p0 = np.array([0.0, 0.0, 4.0])
    X = p0[None] + u[:, :1] * a[None] + u[:, 1:] * b[None]
    x1, x2 = _project(X, R, t)
    if noise:
        x1 = x1 + r.standard_normal(x1.shape) * noise
        x2 = x2 + r.standard_normal(x2.shape) * noise
    return R, t, x1, x2


@pytest.mark.slow
def test_planar_scene_5pt_recovers_8pt_fails(rng):
    """Coplanar points: the 5-point robust path recovers the pose while
    the 8-point minimal solver cannot (its solution space is 2-dim on a
    plane, so the recovered E is essentially arbitrary)."""
    r = np.random.default_rng(2)
    R, t, x1, x2 = _planar_scene(r, n=60, noise=2e-4)
    p1, p2 = _to_px(x1), _to_px(x2)
    K = jnp.asarray(_K)
    key = jax.random.PRNGKey(0)
    mask = jnp.ones(x1.shape[0], bool)

    def pose_err(res):
        Rr, tr, _, _ = EP.recover_pose(
            res.model, jnp.asarray(x1), jnp.asarray(x2)
        )
        r_err = np.rad2deg(
            np.arccos(np.clip((np.trace(np.asarray(Rr).T @ R) - 1) / 2, -1, 1))
        )
        t_err = np.rad2deg(
            np.arccos(np.clip(abs(float(np.asarray(tr) @ t)), -1, 1))
        )
        return r_err, t_err

    res5 = RB.find_essential(
        key, jnp.asarray(p1), jnp.asarray(p2), K, mask, solver="5pt",
        num_hypotheses=256,
    )
    r5, t5 = pose_err(res5)
    assert r5 < 1.0 and t5 < 3.0, (r5, t5)

    res8 = RB.find_essential(
        key, jnp.asarray(p1), jnp.asarray(p2), K, mask, solver="8pt",
        num_hypotheses=256,
    )
    r8, t8 = pose_err(res8)
    # The 8-point pose on a plane is unreliable; assert the 5-point one is
    # strictly and substantially better rather than pinning 8pt's failure
    # mode (any of the 2-dim solution family can win its RANSAC).
    assert (r8 + t8) > 2.0 * (r5 + t5) or (r8 > 5.0 or t8 > 5.0), (r8, t8, r5, t5)


@pytest.mark.slow
def test_general_scene_robust_5pt(rng):
    """General (non-planar) scene with outliers through the full robust
    path: pose within a degree."""
    r = np.random.default_rng(4)
    R = _rodrigues(r.standard_normal(3) * 0.2)
    t = r.standard_normal(3)
    t /= np.linalg.norm(t)
    X = r.uniform(-2, 2, (80, 3))
    X[:, 2] = r.uniform(3, 8, 80)
    x1, x2 = _project(X, R, t)
    x1 += r.standard_normal(x1.shape) * 1e-4
    x2 += r.standard_normal(x2.shape) * 1e-4
    # 20% outliers
    out = r.random(80) < 0.2
    x2[out] = r.uniform(-0.5, 0.5, (out.sum(), 2))
    res = RB.find_essential(
        jax.random.PRNGKey(1), jnp.asarray(_to_px(x1)), jnp.asarray(_to_px(x2)),
        jnp.asarray(_K), jnp.ones(80, bool),
        num_hypotheses=256,
    )
    Rr, tr, _, _ = EP.recover_pose(res.model, jnp.asarray(x1), jnp.asarray(x2))
    r_err = np.rad2deg(np.arccos(np.clip((np.trace(np.asarray(Rr).T @ R) - 1) / 2, -1, 1)))
    t_err = np.rad2deg(np.arccos(np.clip(abs(float(np.asarray(tr) @ t)), -1, 1)))
    assert r_err < 1.0 and t_err < 2.0, (r_err, t_err)
    # Inliers found: most of the clean points.
    inl = np.asarray(res.inlier_mask)
    assert inl[~out].mean() > 0.8
