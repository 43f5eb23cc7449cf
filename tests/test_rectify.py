"""Golden tests: stereo_rectify and remap vs OpenCV."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from stereo_reconstruction_cv_tpu.ops import rectify as RC


K_REF = np.array([[2253.71, 0, 1929.69], [0, 2244.72, 1057.63], [0, 0, 1.0]])
DIST_REF = np.array([0.2090, -0.5576, -7.2e-6, 5.2e-4, 0.3812])


def assert_rectify_matches_cv2(
    K1, d1, K2, d2, size, R, T, alpha, atol=1e-4, new_image_size=None
):
    R1c, R2c, P1c, P2c, Qc, _, _ = cv2.stereoRectify(
        K1, d1, K2, d2, size, R, T.reshape(3, 1), alpha=alpha,
        newImageSize=new_image_size if new_image_size is not None else (0, 0),
    )
    res = RC.stereo_rectify(
        jnp.asarray(K1),
        None if d1 is None else jnp.asarray(d1),
        jnp.asarray(K2),
        None if d2 is None else jnp.asarray(d2),
        size,
        jnp.asarray(R),
        jnp.asarray(T),
        alpha=alpha,
        new_image_size=new_image_size,
    )
    np.testing.assert_allclose(np.asarray(res.R1), R1c, atol=atol)
    np.testing.assert_allclose(np.asarray(res.R2), R2c, atol=atol)
    np.testing.assert_allclose(np.asarray(res.P1), P1c, atol=atol * np.abs(P1c).max())
    np.testing.assert_allclose(np.asarray(res.P2), P2c, atol=atol * np.abs(P2c).max())
    np.testing.assert_allclose(np.asarray(res.Q), Qc, atol=atol * np.abs(Qc).max())


class TestStereoRectify:
    def test_reference_setup_alpha1(self):
        """The exact reference call: K from calibration, near-identity R,
        unit-x T, alpha=1.0, 4K (main.ipynb cells 5-8)."""
        R = cv2.Rodrigues(np.array([0.002, -0.01, 0.004]))[0]
        T = np.array([0.99995, 0.00964, -0.00387])
        assert_rectify_matches_cv2(K_REF, None, K_REF, None, (3840, 2160), R, T, 1.0)

    def test_notebook_cell3_identity(self):
        """Notebook stereo_rectify wrapper: R=I, T=[baseline,0,0], dist=None."""
        assert_rectify_matches_cv2(
            K_REF, None, K_REF, None, (3840, 2160), np.eye(3), np.array([135.0, 0, 0]), -1.0
        )

    @pytest.mark.parametrize("alpha", [-1.0, 0.0, 0.5, 1.0])
    def test_with_distortion(self, alpha):
        R = cv2.Rodrigues(np.array([0.01, 0.12, -0.03]))[0]
        T = np.array([-0.8, 0.05, 0.1])
        assert_rectify_matches_cv2(
            K_REF, DIST_REF, K_REF * 1.01, DIST_REF * 0.5, (1920, 1080), R, T, alpha
        )

    @pytest.mark.parametrize("alpha", [-1.0, 0.0, 1.0])
    def test_new_image_size(self, alpha):
        """newImageSize != imageSize: cc must center on the ORIGINAL size,
        with the new-size ratio applied only in the alpha branch."""
        R = cv2.Rodrigues(np.array([0.002, -0.01, 0.004]))[0]
        T = np.array([0.99995, 0.00964, -0.00387])
        assert_rectify_matches_cv2(
            K_REF, None, K_REF, None, (3840, 2160), R, T, alpha,
            new_image_size=(1920, 1080),
        )

    def test_vertical_stereo(self):
        R = np.eye(3)
        T = np.array([0.01, -1.0, 0.02])
        assert_rectify_matches_cv2(K_REF, None, K_REF, None, (1920, 1080), R, T, 0.7)


@pytest.mark.slow
class TestRemap:
    def test_map_matches_cv2(self):
        R1, _, P1, _, _, _, _ = cv2.stereoRectify(
            K_REF, DIST_REF, K_REF, DIST_REF, (640, 360), np.eye(3),
            np.array([[1.0], [0.0], [0.0]]), alpha=1.0,
        )
        m1, m2 = cv2.initUndistortRectifyMap(
            K_REF, DIST_REF, R1, P1, (640, 360), cv2.CV_32FC1
        )
        ours = np.asarray(
            RC.rectify_map(
                jnp.asarray(K_REF), jnp.asarray(DIST_REF), jnp.asarray(R1),
                jnp.asarray(P1), (640, 360), dtype=jnp.float64,
            )
        )
        np.testing.assert_allclose(ours[..., 0], m1, atol=5e-2)
        np.testing.assert_allclose(ours[..., 1], m2, atol=5e-2)

    def test_remap_bilinear_matches_cv2(self, rng):
        img = rng.integers(0, 255, size=(80, 100)).astype(np.uint8)
        mx = rng.uniform(-5, 105, size=(60, 70)).astype(np.float32)
        my = rng.uniform(-5, 85, size=(60, 70)).astype(np.float32)
        ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
        ours = np.asarray(
            RC.remap_bilinear(jnp.asarray(img), jnp.stack([jnp.asarray(mx), jnp.asarray(my)], axis=-1))
        )
        # Allow off-by-one from rounding; require near-exact agreement.
        close = np.abs(ours.astype(int) - ref.astype(int)) <= 1
        assert close.mean() > 0.999

    def test_fused_rectify_remap_end_to_end(self, rng):
        img = rng.integers(0, 255, size=(360, 640)).astype(np.uint8)
        R1, _, P1, _, _, _, _ = cv2.stereoRectify(
            K_REF / 6, None, K_REF / 6, None, (640, 360), np.eye(3),
            np.array([[1.0], [0.0], [0.0]]), alpha=1.0,
        )
        K = K_REF.copy() / 6
        K[2, 2] = 1.0
        m1, m2 = cv2.initUndistortRectifyMap(K, None, R1, P1, (640, 360), cv2.CV_32FC1)
        ref = cv2.remap(img, m1, m2, cv2.INTER_LINEAR)
        ours = np.asarray(
            RC.rectify_remap(jnp.asarray(img), jnp.asarray(K), None, jnp.asarray(R1), jnp.asarray(P1))
        )
        close = np.abs(ours.astype(int) - ref.astype(int)) <= 1
        assert close.mean() > 0.995


class TestPackedRemap:
    def test_packed_u8_equals_generic(self, rng):
        """The one-gather packed-uint32 fast path is bit-identical to the
        generic four-tap path, including all border cases."""
        img = rng.integers(0, 255, size=(50, 64)).astype(np.uint8)
        mx = rng.uniform(-8, 72, size=(40, 48)).astype(np.float32)
        my = rng.uniform(-8, 58, size=(40, 48)).astype(np.float32)
        m = jnp.stack([jnp.asarray(mx), jnp.asarray(my)], axis=-1)
        fast = np.asarray(RC._remap_bilinear_packed_u8(jnp.asarray(img), m))
        # uint16 input routes to the generic path with identical values.
        gen = np.asarray(RC.remap_bilinear(jnp.asarray(img).astype(jnp.uint16), m))
        np.testing.assert_array_equal(fast.astype(np.int32), gen.astype(np.int32))


class TestAffineResample:
    @pytest.mark.slow  # full-frame compare; packed-remap parity stays fast
    def test_affine_path_matches_gather(self, rng):
        """Identity-R rectification takes the banded-matmul path
        (_affine_resample); it must agree with the map+gather path to one
        u8 level everywhere (only f32 summation order differs)."""
        img = jnp.asarray(rng.integers(0, 255, size=(120, 160)).astype(np.uint8))
        K = np.array([[140.0, 0, 83.0], [0, 150.0, 61.0], [0, 0, 1.0]])
        P = np.array([[120.0, 0, 80.0, 0], [0, 131.0, 59.0, 0], [0, 0, 1.0, 0]])
        R = np.eye(3)
        params = RC._affine_params(
            jnp.asarray(K), None, jnp.asarray(R), jnp.asarray(P), (160, 120))
        assert params is not None
        fast = np.asarray(RC.rectify_remap(
            img, jnp.asarray(K), None, jnp.asarray(R), jnp.asarray(P)))
        m = RC.rectify_map(jnp.asarray(K), None, jnp.asarray(R),
                           jnp.asarray(P), (160, 120))
        ref = np.asarray(RC.remap_bilinear(img, m))
        assert np.abs(fast.astype(int) - ref.astype(int)).max() <= 1
        # a rotated R must NOT take the affine path
        Rr = np.array([[0.999, -0.04, 0.0], [0.04, 0.999, 0.0], [0, 0, 1.0]])
        assert RC._affine_params(
            jnp.asarray(K), None, jnp.asarray(Rr), jnp.asarray(P), (160, 120)
        ) is None
