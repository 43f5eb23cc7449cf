"""StageCache wiring across the pipeline (SURVEY §5 checkpoint/resume row).

Geometry, rectify and disparity must all restart from
their persisted npz — a second `cli reconstruct` on the same pair skips
straight to SGBM (and a second disparity call skips even that).
"""

import numpy as np
import pytest

from stereo_reconstruction_cv_tpu.pipeline import stages
from stereo_reconstruction_cv_tpu.pipeline.cache import StageCache


@pytest.fixture()
def pair(rng):
    base = rng.uniform(0, 255, size=(120, 176)).astype(np.float32)
    imL = base[:, 16:].astype(np.uint8)
    imR = base[:, :-16].astype(np.uint8)
    return imL, imR


def test_disparity_cache_roundtrip(tmp_path, pair, monkeypatch):
    imL, imR = pair
    cache = StageCache(str(tmp_path / "c"))
    d1 = stages.disparity(imL, imR, ndisp=16, cache=cache)
    # Second call must come from cache: poison the compute path.
    from stereo_reconstruction_cv_tpu.ops import disparity as DP

    def boom(*a, **k):
        raise AssertionError("cache miss: compute_disparity_map re-ran")

    monkeypatch.setattr(DP, "compute_disparity_map", boom)
    d2 = stages.disparity(imL, imR, ndisp=16, cache=cache)
    np.testing.assert_array_equal(d1, d2)
    # Different params -> different key -> compute path (and the poison).
    with pytest.raises(AssertionError):
        stages.disparity(imL, imR, ndisp=32, cache=cache)


@pytest.mark.slow
def test_geometry_and_rectify_cache_roundtrip(tmp_path):
    import cv2

    imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (480, 270))
    imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (480, 270))
    cache = StageCache(str(tmp_path / "c"))
    g1 = stages.estimate_geometry((imL, imR), cache=cache)
    g2 = stages.estimate_geometry((imL, imR), cache=cache)
    for k in ("Essential Matrix", "Rotation Matrix", "F", "pts1", "inlier_mask"):
        np.testing.assert_array_equal(g1[k], g2[k])
    assert g2["num_matches"] == g1["num_matches"]

    r1 = stages.rectify_pair((imL, imR), with_visualizations=False, cache=cache)
    r2 = stages.rectify_pair((imL, imR), with_visualizations=False, cache=cache)
    np.testing.assert_array_equal(r1["left_rectified"], r2["left_rectified"])
    np.testing.assert_array_equal(r1["Q"], r2["Q"])
    assert r2["geometry"]["num_matches"] == r1["geometry"]["num_matches"]
    assert isinstance(r2["epiline_mean_abs_slope"], float)
