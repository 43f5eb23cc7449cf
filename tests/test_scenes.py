"""Seeded synthetic scenes: the ground truth they carry is right."""

import numpy as np
import pytest

from stereo_reconstruction_cv_tpu import scenes


@pytest.fixture(scope="module")
def scene():
    return scenes.make_scene(96, 160, 32, seed=7)


def test_deterministic_in_seed(scene):
    again = scenes.make_scene(96, 160, 32, seed=7)
    other = scenes.make_scene(96, 160, 32, seed=8)
    for a, b in zip(scene, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(scene.left, other.left)


def test_disparity_range_and_occlusion(scene):
    assert scene.left.dtype == np.uint8 and scene.left.shape == (96, 160)
    assert scene.disparity.min() >= 0.08 * 32 - 1e-3
    assert scene.disparity.max() <= 0.9 * 32 + 1e-3
    # Occlusions exist (objects in front of the background) but are a
    # minority; the left border pixels whose partner leaves the frame are
    # always occluded.
    assert 0.0 < scene.occluded.mean() < 0.3
    cols = np.arange(160)[None, :]
    assert scene.occluded[cols - scene.disparity < -0.5].all()


def test_visible_pixels_match_along_the_true_disparity(scene):
    """A non-occluded left pixel shows the same surface as the right view
    at x - d (linear interpolation along the row): only the per-view
    sensor noise (sigma 1) and resampling separate them."""
    H, W = scene.left.shape
    ys, xs = np.nonzero(~scene.occluded)
    xr = xs - scene.disparity[ys, xs]
    x0 = np.clip(np.floor(xr).astype(int), 0, W - 2)
    f = xr - x0
    right = scene.right.astype(np.float32)
    sampled = right[ys, x0] * (1 - f) + right[ys, x0 + 1] * f
    err = np.abs(sampled - scene.left[ys, xs].astype(np.float32))
    assert np.median(err) < 4.0
    # ...while a wrong disparity does not match.
    x_off = np.clip(np.rint(xs - scene.disparity[ys, xs] - 3).astype(int), 0, W - 1)
    assert np.median(np.abs(right[ys, x_off] - scene.left[ys, xs])) > 3 * np.median(err)


def test_rectified_ground_truth_identity_rectification(scene):
    """With R = I and P = [K | 0] the rectified view is the source view:
    the ground truth comes back unchanged."""
    K = scenes.anchor_k(160)
    P = np.hstack([K, np.zeros((3, 1))])
    gt, known = scenes.rectified_ground_truth(scene, K, np.eye(3), P, np.eye(3), P)
    np.testing.assert_allclose(gt, scene.disparity, atol=1e-3)
    np.testing.assert_array_equal(known, ~scene.occluded)


def test_rectified_ground_truth_scales_with_focal_length(scene):
    """Rectifying to a camera with focal length s*f scales disparity by s."""
    K = scenes.anchor_k(160)
    Kn = K.copy()
    Kn[:2, :2] *= 0.5
    P = np.hstack([Kn, np.zeros((3, 1))])
    gt, known = scenes.rectified_ground_truth(scene, K, np.eye(3), P, np.eye(3), P)
    H, W = gt.shape
    yn, xn = np.mgrid[0:H, 0:W]
    xs = np.rint(K[0, 0] * (xn - Kn[0, 2]) / Kn[0, 0] + K[0, 2]).astype(int)
    ys = np.rint(K[1, 1] * (yn - Kn[1, 2]) / Kn[1, 1] + K[1, 2]).astype(int)
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    assert np.array_equal(known, inside & ~scene.occluded[ys.clip(0, H - 1), xs.clip(0, W - 1)])
    want = 0.5 * scene.disparity[ys.clip(0, H - 1), xs.clip(0, W - 1)]
    np.testing.assert_allclose(gt[known], want[known], rtol=1e-4, atol=1e-3)
