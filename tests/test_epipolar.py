"""Tests: 8-point F/E, decomposition, recoverPose, robust RANSAC/LMedS.

Quality gates are residual-based, not bit-equal to cv2 (SURVEY §7 hard part
4: RANSAC determinism differs; we accept different inlier sets of equal or
better quality)."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_reconstruction_cv_tpu.ops import epipolar as EP
from stereo_reconstruction_cv_tpu.ops import geometry as G
from stereo_reconstruction_cv_tpu.ops import robust as RB


def make_scene(rng, n=200, noise=0.0, outlier_frac=0.0):
    """Synthetic two-view scene with known K, R, t."""
    K = np.array([[2250.0, 0, 1920.0], [0, 2245.0, 1080.0], [0, 0, 1.0]])
    rvec = np.array([0.03, 0.25, -0.02])
    R = cv2.Rodrigues(rvec)[0]
    t = np.array([-1.0, 0.04, 0.1])
    t /= np.linalg.norm(t)
    X = rng.uniform(-3, 3, size=(n, 3)) + np.array([0, 0, 10.0])
    x1 = cv2.projectPoints(X, np.zeros(3), np.zeros(3), K, None)[0].reshape(-1, 2)
    x2 = cv2.projectPoints(X, rvec, t, K, None)[0].reshape(-1, 2)
    x1 += rng.normal(size=x1.shape) * noise
    x2 += rng.normal(size=x2.shape) * noise
    n_out = int(n * outlier_frac)
    if n_out:
        x2[:n_out] = rng.uniform(0, [3840, 2160], size=(n_out, 2))
    E = EP.essential_from_Rt(jnp.asarray(R), jnp.asarray(t))
    F = np.asarray(EP.fundamental_from_essential(E, jnp.asarray(K), jnp.asarray(K)))
    return dict(K=K, R=R, t=t, X=X, x1=x1, x2=x2, F=F / F[2, 2], n_out=n_out)


class TestEightPoint:
    def test_noise_free_recovers_F(self, rng):
        sc = make_scene(rng)
        F = np.asarray(EP.eight_point(jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"])))
        res = np.asarray(G.sampson_error(jnp.asarray(F), jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"])))
        assert np.sqrt(res).max() < 1e-6

    def test_weighted_ignores_masked_points(self, rng):
        sc = make_scene(rng, n=100)
        x2_bad = sc["x2"].copy()
        x2_bad[:20] = rng.uniform(0, 1000, size=(20, 2))
        w = np.ones(100)
        w[:20] = 0.0
        F = np.asarray(
            EP.eight_point(jnp.asarray(sc["x1"]), jnp.asarray(x2_bad), weights=jnp.asarray(w))
        )
        res = np.asarray(
            G.sampson_error(jnp.asarray(F), jnp.asarray(sc["x1"][20:]), jnp.asarray(sc["x2"][20:]))
        )
        assert np.sqrt(res).max() < 1e-5

    def test_comparable_to_cv2_8point(self, rng):
        sc = make_scene(rng, noise=0.5)
        F_cv, _ = cv2.findFundamentalMat(sc["x1"], sc["x2"], cv2.FM_8POINT)
        F = np.asarray(EP.eight_point(jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"])))
        r_ours = np.sqrt(np.asarray(G.sampson_error(jnp.asarray(F), jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"])))).mean()
        r_cv = np.sqrt(np.asarray(G.sampson_error(jnp.asarray(F_cv), jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"])))).mean()
        assert r_ours < r_cv * 1.5 + 1e-3


class TestEssentialAndPose:
    def test_decompose_essential_matches_cv2(self, rng):
        sc = make_scene(rng)
        E = np.asarray(EP.essential_from_Rt(jnp.asarray(sc["R"]), jnp.asarray(sc["t"])))
        R1, R2, t = EP.decompose_essential(jnp.asarray(E))
        R1c, R2c, tc = cv2.decomposeEssentialMat(E)
        ours = {tuple(np.round(np.asarray(m).ravel(), 6)) for m in (R1, R2)}
        cvs = {tuple(np.round(m.ravel(), 6)) for m in (R1c, R2c)}
        assert ours == cvs
        np.testing.assert_allclose(np.abs(np.asarray(t)), np.abs(tc.ravel()), atol=1e-6)

    def test_recover_pose_true_solution(self, rng):
        sc = make_scene(rng)
        E = EP.essential_from_Rt(jnp.asarray(sc["R"]), jnp.asarray(sc["t"]))
        n1 = EP.pixel_to_normalized(jnp.asarray(sc["x1"]), jnp.asarray(sc["K"]))
        n2 = EP.pixel_to_normalized(jnp.asarray(sc["x2"]), jnp.asarray(sc["K"]))
        R, t, mask, votes = EP.recover_pose(E, n1, n2)
        np.testing.assert_allclose(np.asarray(R), sc["R"], atol=1e-5)
        np.testing.assert_allclose(np.asarray(t), sc["t"], atol=1e-5)
        assert int(votes) == len(sc["x1"])

    def test_recover_pose_matches_cv2(self, rng):
        sc = make_scene(rng, noise=0.3)
        E_cv, _ = cv2.findEssentialMat(sc["x1"], sc["x2"], sc["K"], cv2.RANSAC, 0.999, 1.0)
        _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, sc["x1"], sc["x2"], sc["K"])
        n1 = EP.pixel_to_normalized(jnp.asarray(sc["x1"]), jnp.asarray(sc["K"]))
        n2 = EP.pixel_to_normalized(jnp.asarray(sc["x2"]), jnp.asarray(sc["K"]))
        R, t, _, _ = EP.recover_pose(jnp.asarray(E_cv), n1, n2)
        np.testing.assert_allclose(np.asarray(R), R_cv, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), t_cv.ravel(), atol=1e-4)


@pytest.mark.slow
class TestRobust:
    def test_lmeds_fundamental_rejects_outliers(self, rng):
        sc = make_scene(rng, n=300, noise=0.3, outlier_frac=0.3)
        key = jax.random.PRNGKey(0)
        res = RB.find_fundamental(
            key, jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"]), method="lmeds"
        )
        inl = np.asarray(res.inlier_mask)
        # Outliers live at indices [:n_out]; nearly all must be rejected.
        assert inl[: sc["n_out"]].sum() <= sc["n_out"] * 0.05
        assert inl[sc["n_out"] :].mean() > 0.9
        # Model quality on the clean points: sub-pixel epipolar distance.
        d = np.asarray(
            G.epipolar_distance(res.model, jnp.asarray(sc["x1"][sc["n_out"]:]), jnp.asarray(sc["x2"][sc["n_out"]:]))
        )
        assert np.median(d) < 1.0

    def test_ransac_essential_quality_vs_cv2(self, rng):
        sc = make_scene(rng, n=300, noise=0.3, outlier_frac=0.2)
        key = jax.random.PRNGKey(1)
        res = RB.find_essential(
            key, jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"]), jnp.asarray(sc["K"])
        )
        n1 = EP.pixel_to_normalized(jnp.asarray(sc["x1"]), jnp.asarray(sc["K"]))
        n2 = EP.pixel_to_normalized(jnp.asarray(sc["x2"]), jnp.asarray(sc["K"]))
        R, t, _, _ = EP.recover_pose(res.model, n1, n2, weights=res.inlier_mask.astype(n1.dtype))
        # Pose error vs ground truth.
        dR = np.asarray(R) @ sc["R"].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.5, f"rotation error {ang} deg"
        assert np.abs(np.asarray(t) - sc["t"]).max() < 0.02

    def test_static_shape_mask_path(self, rng):
        """Points padded to a static size with a mask must give the same
        model as the unpadded call — the static-shape calling convention."""
        sc = make_scene(rng, n=100, noise=0.2)
        pad = 156
        x1p = np.vstack([sc["x1"], np.zeros((pad, 2))])
        x2p = np.vstack([sc["x2"], np.zeros((pad, 2))])
        m = np.zeros(256, bool)
        m[:100] = True
        key = jax.random.PRNGKey(2)
        res_p = RB.find_fundamental(key, jnp.asarray(x1p), jnp.asarray(x2p), mask=jnp.asarray(m))
        assert not res_p.inlier_mask[100:].any()
        d = np.asarray(
            G.epipolar_distance(res_p.model, jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"]))
        )
        assert np.median(d) < 1.0

    def test_jit_compiles_once_and_runs(self, rng):
        sc = make_scene(rng, n=128, noise=0.2)
        fn = jax.jit(lambda k, a, b: RB.find_fundamental(k, a, b, method="lmeds"))
        r1 = fn(jax.random.PRNGKey(0), jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"]))
        r2 = fn(jax.random.PRNGKey(3), jnp.asarray(sc["x1"]), jnp.asarray(sc["x2"]))
        assert int(r1.num_inliers) > 100 and int(r2.num_inliers) > 100
