"""CLI smoke tests on downscaled bundled data (headless tab equivalents)."""

import os

import cv2
import numpy as np
import pytest

from stereo_reconstruction_cv_tpu import cli


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (320, 184))
    imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (320, 184))
    cv2.imwrite(str(d / "img1.jpg"), imL)
    cv2.imwrite(str(d / "img2.jpg"), imR)
    return str(d)


@pytest.mark.slow
def test_match_verb(tiny_pair, capsys):
    rc = cli.main(["match", tiny_pair])
    assert rc == 0
    out = capsys.readouterr().out
    assert "good matches" in out


@pytest.mark.slow
def test_match_learned_verb(tiny_pair, capsys):
    rc = cli.main(["match", tiny_pair, "--learned"])
    assert rc == 0
    assert "keypoints" in capsys.readouterr().out


@pytest.mark.slow
def test_disparity_verb(tiny_pair, tmp_path, capsys):
    outdir = str(tmp_path / "disp")
    rc = cli.main(["disparity", tiny_pair, "--ndisp", "32", "--outdir", outdir])
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "disparity.npy"))
    assert os.path.exists(os.path.join(outdir, "disparity_jet.png"))
    disp = np.load(os.path.join(outdir, "disparity.npy"))
    assert disp.shape == (184, 320)


@pytest.mark.slow
def test_geometry_verb(tiny_pair, capsys):
    rc = cli.main(["geometry", tiny_pair, "--baseline", "0.14"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Essential Matrix" in out and "Translation Vector" in out


@pytest.mark.slow
def test_report_verb(tiny_pair, tmp_path, capsys):
    out = str(tmp_path / "report.html")
    rc = cli.main(["report", tiny_pair, "--ndisp", "16", "--output", out])
    assert rc == 0
    html = open(out).read()
    assert html.startswith("<!DOCTYPE html>")
    # every stage section present, imagery embedded, viewer inlined
    for sec in ("Feature detection", "Rectification + geometry",
                "Dense disparity", "3D reconstruction", "Pipeline metrics"):
        assert sec in html
    assert "data:image/png;base64," in html
    assert "srcdoc=" in html
    # The observability registry is embedded.
    assert "time/rectify_pair_s" in html


@pytest.mark.slow
def test_metrics_dump(tiny_pair, tmp_path, capsys):
    """--metrics dumps the per-stage observability registry:
    stage timings plus the counts the reference prints."""
    import json

    from stereo_reconstruction_cv_tpu.utils.profiling import METRICS

    METRICS.reset()
    out = str(tmp_path / "m.json")
    outdir = str(tmp_path / "disp")
    rc = cli.main(["--metrics", out, "disparity", tiny_pair, "--ndisp", "32",
                   "--outdir", outdir])
    assert rc == 0
    m = json.load(open(out))
    assert m["time/disparity_calls"] >= 1
    assert m["time/disparity_s"] > 0


@pytest.mark.slow
def test_metrics_records_counts(tiny_pair, tmp_path):
    import json

    from stereo_reconstruction_cv_tpu.utils.profiling import METRICS

    METRICS.reset()
    out = str(tmp_path / "m.json")
    rc = cli.main(["--metrics", out, "geometry", tiny_pair, "--baseline", "0.14"])
    assert rc == 0
    m = json.load(open(out))
    assert m["estimate_geometry/num_matches"] > 0
    assert m["estimate_geometry/num_inliers_E"] > 0
    assert m["time/estimate_geometry_s"] > 0


def test_baseline_validation_falls_back(tiny_pair, capsys, monkeypatch):
    """GUI parity (gui.py:465-472): non-positive baseline warns and uses
    the default 0.1 instead of erroring."""
    seen = {}

    def fake_geometry(args):
        seen["baseline"] = args.baseline
        return 0

    import stereo_reconstruction_cv_tpu.cli as C

    monkeypatch.setattr(C, "cmd_geometry", fake_geometry)
    rc = C.main(["geometry", tiny_pair, "--baseline", "-3"])
    assert rc == 0
    assert seen["baseline"] == 0.1
    assert "Invalid baseline" in capsys.readouterr().err


def test_contrast_threshold_validation_falls_back(tiny_pair, capsys, monkeypatch):
    """GUI parity (gui.py:546-553): contrast threshold outside [0, 0.1]
    warns and uses the default 0.04."""
    seen = {}

    def fake_match(args):
        seen["ct"] = args.contrast_threshold
        return 0

    import stereo_reconstruction_cv_tpu.cli as C

    monkeypatch.setattr(C, "cmd_match", fake_match)
    rc = C.main(["match", tiny_pair, "--contrast-threshold", "0.5"])
    assert rc == 0
    assert seen["ct"] == 0.04
    assert "Invalid contrast threshold" in capsys.readouterr().err
