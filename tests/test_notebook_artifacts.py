"""Consolidated notebook-artifact parity.

The reference notebook's executed artifact set (main.ipynb cell 7
+100-104, cell 13 +16-18):
  left_rectified.jpg, right_rectified.jpg,
  left_rectified_lines.jpg, right_rectified_lines.jpg,
  {dataset}_point_cloud.ply
plus the disparity jet rendering (cell 13 +4-8, shown inline there; the
headless flow saves it). One slow-tier test runs examples/notebook_flow.py
end to end on downscaled bundled data and asserts every artifact exists
and parses.

Runs IN-PROCESS (not a subprocess): the flow then shares this pytest
process's jit caches with the pipeline/CLI tests that compile the same
stage programs — a subprocess re-pays full trace+lower+compile (~20 min
on the 1-core dev host).
"""

import os
import sys

import cv2
import numpy as np
import pytest

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.slow
def test_notebook_flow_writes_reference_artifact_set(tmp_path, monkeypatch):
    # Downscaled calib subset + pair keep the run CPU-friendly.
    calib = tmp_path / "calib"
    calib.mkdir()
    src = "/root/reference/calibration_data_logitech_3840x2160"
    names = sorted(os.listdir(src))[:6]
    for n in names:
        im = cv2.imread(os.path.join(src, n), 0)
        cv2.imwrite(str(calib / n), cv2.resize(im, (960, 540)))
    # d2 at 320x184: the shape the CLI/pipeline tests already compile.
    pair = tmp_path / "d2"
    pair.mkdir()
    for i in (1, 2):
        im = cv2.imread(f"/root/reference/dataset/d2/img{i}.jpg", 0)
        cv2.imwrite(str(pair / f"img{i}.jpg"), cv2.resize(im, (320, 184)))
    (pair / "baseline.txt").write_text("140mm\n")

    outdir = tmp_path / "out"
    sys.path.insert(0, os.path.join(_REPO, "examples"))
    try:
        import notebook_flow
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", [
        "notebook_flow.py", "--calib-dir", str(calib), "--pair", str(pair),
        "--outdir", str(outdir), "--ndisp", "32", "--max-calib-images", "6",
    ])
    assert notebook_flow.main() == 0

    for name in (
        "left_rectified.jpg",
        "right_rectified.jpg",
        "left_rectified_lines.jpg",
        "right_rectified_lines.jpg",
        "disparity_jet.png",
        "d2_point_cloud.ply",
    ):
        assert (outdir / name).exists(), f"missing artifact {name}"
    # Artifacts parse: images load, PLY roundtrips.
    for name in ("left_rectified.jpg", "disparity_jet.png"):
        assert cv2.imread(str(outdir / name)) is not None
    from stereo_reconstruction_cv_tpu.io.ply import read_ply

    # At this smoke scale the uncalibrated two-view geometry can be too
    # sparse for a dense cloud; the contract asserted here is the
    # reference's artifact SET and that every artifact parses (the cloud
    # QUALITY gates live in test_pipeline/test_disparity at real scales).
    pts, _ = read_ply(str(outdir / "d2_point_cloud.ply"))
    assert np.isfinite(pts).all()
