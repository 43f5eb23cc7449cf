"""End-to-end pipeline tests on the bundled reference datasets."""

import os

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from stereo_reconstruction_cv_tpu.io import image as IO
from stereo_reconstruction_cv_tpu.io import ply as PLY
from stereo_reconstruction_cv_tpu.pipeline import stages


K_REF = np.array([[2253.71, 0, 1929.69], [0, 2244.72, 1057.63], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def d3_half():
    imL = cv2.resize(cv2.imread("/root/reference/dataset/d3/img1.jpg", 0), (1920, 1080))
    imR = cv2.resize(cv2.imread("/root/reference/dataset/d3/img2.jpg", 0), (1920, 1080))
    K = K_REF.copy() / 2
    K[2, 2] = 1.0
    return imL, imR, K


class TestIO:
    def test_pair_convention(self):
        imL, imR = IO.load_stereo_pair("/root/reference/dataset/d2")
        assert imL.shape == imR.shape == (1080, 1920)

    def test_missing_pair_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            IO.load_stereo_pair(str(tmp_path))

    def test_baseline_txt(self):
        b = IO.read_baseline("/root/reference/dataset/d3")
        assert abs(b - 0.140) < 1e-9  # 140mm

    def test_ply_roundtrip(self, tmp_path, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        cols = rng.integers(0, 255, size=(100, 3)).astype(np.uint8)
        p = str(tmp_path / "c.ply")
        PLY.write_ply(p, pts, cols)
        pts2, cols2 = PLY.read_ply(p)
        np.testing.assert_allclose(pts2, pts, rtol=1e-6)
        np.testing.assert_array_equal(cols2, cols)
        # ascii mode
        PLY.write_ply(p, pts, cols, binary=False)
        pts3, cols3 = PLY.read_ply(p)
        np.testing.assert_allclose(pts3, pts, atol=1e-4)


@pytest.mark.slow
class TestGeometryE2E:
    def test_d3_pose_matches_reference_anchor(self, d3_half):
        """Reference anchor (main.ipynb cell 6): R ~ identity (max offdiag
        0.04), T ~ [0.99995, 0.00964, -0.00387] on dataset/d3 with the
        calibrated K. Our detector differs from SIFT, so tolerances are
        loose but directional."""
        imL, imR, K = d3_half
        out = stages.estimate_geometry((imL, imR), baseline=0.140, camera_matrix=K)
        T = out["Translation Vector"].ravel()
        T = T * np.sign(T[0])
        R = out["Rotation Matrix"]
        assert T[0] > 0.98, T
        assert abs(T[1]) < 0.06, T
        assert abs(T[2]) < 0.20, T
        assert np.abs(R - np.eye(3)).max() < 0.10
        assert out["num_inliers_E"] > 20

    def test_rectification_flattens_epilines(self, d3_half):
        imL, imR, K = d3_half
        out = stages.rectify_pair((imL, imR), baseline=0.140, camera_matrix=K,
                                  with_visualizations=False)
        # after rectification epilines must be horizontal: |slope| small
        assert out["epiline_mean_abs_slope"] < 0.02, out["epiline_mean_abs_slope"]
        assert out["left_rectified"].shape == imL.shape

    def test_triangulate_sparse_d3(self, d3_half):
        imL, imR, K = d3_half
        out = stages.triangulate_sparse((imL, imR), camera_matrix=K, baseline=0.140)
        assert out["num_points"] > 20
        pts = out["points"][out["valid"]]
        # all retained points have positive depth, metric-ish scale
        assert (pts[:, 2] > 0).all()


class TestDenseE2E:
    def test_disparity_reconstruct_export(self, tmp_path, rng):
        imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (480, 270))
        imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (480, 270))
        disp = stages.disparity(imL, imR, ndisp=32, mindis=0)
        assert disp.shape == imL.shape
        assert (disp >= 0).all()
        assert (disp > 0).mean() > 0.1
        Q = np.array(
            [[1, 0, 0, -240.0], [0, 1, 0, -135.0], [0, 0, 0, 255.0], [0, 0, 1 / 0.14, 0]]
        )
        pts = stages.reconstruct(disp, Q)
        assert pts.shape == (270, 480, 3)
        out = str(tmp_path / "cloud.ply")
        n = stages.export_point_cloud(out, pts, disp)
        assert n > 1000
        pts2, _ = PLY.read_ply(out)
        assert len(pts2) == n
        assert np.isfinite(pts2).all()


@pytest.mark.slow
class TestLearnedMatcher:
    def test_checkpoint_restores_and_matches(self):
        """The shipped checkpoint must load cross-device and outperform a
        fresh init on the bundled pair (235 vs ~74 matches at train time)."""
        import os

        ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "xfeat_v0.npz")
        if not os.path.exists(ckpt):
            pytest.skip("no shipped checkpoint")
        imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (320, 184))
        imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (320, 184))
        out = stages.detect_match((imL, imR), method="learned", model_checkpoint=ckpt)
        assert out["num_good_matches"] > 100


class TestTypedErrors:
    """Typed error contract (SURVEY §5): error-dicts tag their kind and
    promote to the typed exception family; raises are StereoError."""

    def test_error_dict_promotes(self, tmp_path):
        from stereo_reconstruction_cv_tpu import errors as E
        from stereo_reconstruction_cv_tpu.pipeline import stages

        out = stages.calibrate(str(tmp_path))
        assert out["error_kind"] == "data"
        with pytest.raises(E.DataError):
            E.raise_on_error(out)
        ok = {"K": 1}
        assert E.raise_on_error(ok) is ok

    def test_missing_pair_is_typed_and_stdlib_compatible(self, tmp_path):
        from stereo_reconstruction_cv_tpu import errors as E

        with pytest.raises(E.StereoError):
            IO.load_stereo_pair(str(tmp_path))
        with pytest.raises(FileNotFoundError):  # back-compat
            IO.load_stereo_pair(str(tmp_path))
