"""DoG scale-space SIFT semantics vs cv2.

The reference GUI exposes SIFT's contrastThreshold over [0, 0.1]
(gui.py:212, 546-553). The detector must reproduce cv2's ABSOLUTE
contrast semantics: sweeping the threshold changes keypoint counts the
same way, within 2x, on the bundled pairs.
"""

import cv2
import numpy as np
import pytest

from stereo_reconstruction_cv_tpu.ops import features as FT
from stereo_reconstruction_cv_tpu.ops import matching as M
from stereo_reconstruction_cv_tpu.ops import sift as S


def _load(d, size=(480, 270)):
    imL = cv2.resize(cv2.imread(f"/root/reference/dataset/{d}/img1.jpg", 0), size)
    imR = cv2.resize(cv2.imread(f"/root/reference/dataset/{d}/img2.jpg", 0), size)
    return imL, imR


@pytest.mark.parametrize("ct", [
    pytest.param(0.01, marks=pytest.mark.slow),
    0.04,
    pytest.param(0.08, marks=pytest.mark.slow),
])
def test_keypoint_count_parity_d2(ct):
    img, _ = _load("d2")
    res = S.detect_scale_space(np.asarray(img), ct, max_keypoints=2048)
    ours = int(res.num_detected)
    ref = len(cv2.SIFT_create(contrastThreshold=ct).detect(img, None))
    assert ref / 2 <= ours <= ref * 2, (ct, ours, ref)


@pytest.mark.slow  # three full detect compiles; the ct=0.04 parity case
# stays in the fast tier
def test_threshold_monotone():
    img, _ = _load("d3", size=(384, 216))
    counts = [
        int(S.detect_scale_space(np.asarray(img), ct).num_detected)
        for ct in (0.01, 0.04, 0.08)
    ]
    assert counts[0] > counts[1] > counts[2] > 0


@pytest.mark.slow
def test_good_match_count_parity_d3():
    """Good-match counts (ratio 0.75) within 2x of the cv2 SIFT+FLANN
    pipeline at the same threshold (reference gui.py:211-241)."""
    imL, imR = _load("d3")
    fl = FT.detect_and_describe(np.asarray(imL), 2048, 0.04)
    fr = FT.detect_and_describe(np.asarray(imR), 2048, 0.04)
    mres = M.knn2_match(fl.descriptors, fr.descriptors, fl.mask, fr.mask, ratio=0.75)
    ours = int(mres.mask.sum())

    sift = cv2.SIFT_create(contrastThreshold=0.04)
    k1, d1 = sift.detectAndCompute(imL, None)
    k2, d2 = sift.detectAndCompute(imR, None)
    flann = cv2.FlannBasedMatcher({"algorithm": 1, "trees": 5}, {"checks": 50})
    mm = flann.knnMatch(d1, d2, k=2)
    ref = sum(1 for m, n in mm if m.distance < 0.75 * n.distance)
    assert ref / 2 <= ours <= ref * 2, (ours, ref)


@pytest.mark.slow
def test_dog_sigma_and_position_sanity():
    """Refined keypoints stay in-image with plausible scales."""
    img, _ = _load("d2")
    res = S.detect_scale_space(np.asarray(img), 0.04, max_keypoints=512)
    v = res.scores > 0
    kp = np.asarray(res.keypoints)[np.asarray(v)]
    sig = np.asarray(res.sigmas)[np.asarray(v)]
    H, W = img.shape
    assert (kp[:, 0] >= -1).all() and (kp[:, 0] <= W).all()
    assert (kp[:, 1] >= -1).all() and (kp[:, 1] <= H).all()
    assert (sig > 0.5).all() and (sig < min(H, W)).all()
