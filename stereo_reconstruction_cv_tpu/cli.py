"""Command-line interface — headless verbs replacing the reference's GUI tabs.

Tab mapping (README.md:55-114; gui.py tabs):
  Tab 1 Camera Calibration      -> `calibrate`
  Tab 2 Stereo Rectification    -> `rectify`
  Tab 3 Feature Detect/Match    -> `match`
  Tab 4 Geometry Estimation     -> `geometry`
  Tab 5 Triangulation [branch]  -> `triangulate`
  Tab 6 Disparity/Dense [branch]-> `disparity` / `reconstruct`
  Tab 7 XFeat matching [branch] -> `match --learned`
plus `bench`. Outputs go to files (PNG/NPZ/PLY) instead of Tk windows —
headless-first for accelerator hosts (SURVEY §7 step 8).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def _print_named(results):
    for name, value in results:
        print(f"\n== {name} ==")
        print(value)


def cmd_calibrate(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages

    out = stages.calibrate(args.folder, tuple(args.chessboard))
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 1
    _print_named(out["results"])
    print(f"\nRMS: {out['rms']:.4f}  images used: {out['num_images']}")
    if args.save:
        np.savez(args.save, K=out["K"], dist=out["dist"], rvecs=out["rvecs"], tvecs=out["tvecs"])
        print(f"saved calibration to {args.save}")
    return 0


def _load_K(args):
    if getattr(args, "calibration", None):
        z = np.load(args.calibration)
        return z["K"]
    return None


def _load_dist(args):
    if getattr(args, "calibration", None):
        z = np.load(args.calibration)
        if "dist" in z:
            return z["dist"]
    return None


def cmd_stereo_calibrate(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages

    out = stages.calibrate_stereo_rig(args.folder1, args.folder2, tuple(args.chessboard))
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 1
    for k in ("K1", "dist1", "K2", "dist2", "R", "T"):
        print(f"\n== {k} ==\n{out[k]}")
    print(f"\nrms: {out['rms']:.4f}  pairs used: {out['num_pairs']}")
    if args.save:
        np.savez(args.save, **{k: out[k] for k in ("K1", "dist1", "K2", "dist2", "R", "T")})
        print(f"saved rig calibration to {args.save}")
    return 0


def _default_learned_checkpoint():
    """Shipped trained weights, so --learned without --model never runs a
    randomly initialized net silently. Picks the highest-versioned
    checkpoints/xfeat_v*.npz — the shipped best (docs/XFEAT_EVAL.json tracks
    its evaluation)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "checkpoints")
    cands = sorted(glob.glob(os.path.join(root, "xfeat_v*.npz")))
    if cands:
        return os.path.abspath(cands[-1])
    print("warning: no trained checkpoint found; using fresh-init weights",
          file=sys.stderr)
    return None


def _stage_cache(args):
    """--cache [DIR] -> a StageCache (None when the flag is absent)."""
    d = getattr(args, "cache", None)
    if not d:
        return None
    from stereo_reconstruction_cv_tpu.pipeline.cache import StageCache

    return StageCache(d)


def cmd_rectify(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages
    from stereo_reconstruction_cv_tpu.io.image import save_image

    out = stages.rectify_pair(
        args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
        dist=_load_dist(args) if args.undistort else None,
        cache=_stage_cache(args),
    )
    os.makedirs(args.outdir, exist_ok=True)
    save_image(os.path.join(args.outdir, "left_rectified.jpg"), out["left_rectified"])
    save_image(os.path.join(args.outdir, "right_rectified.jpg"), out["right_rectified"])
    for key in (
        "Left Epilines (before)", "Right Points (before)",
        "Left Epilines (after)", "Right Points (after)",
    ):
        if key in out:
            fname = key.lower().replace(" ", "_").replace("(", "").replace(")", "") + ".png"
            save_image(os.path.join(args.outdir, fname), out[key])
    np.savez(
        os.path.join(args.outdir, "rectification.npz"),
        **{k: out[k] for k in ("R1", "R2", "P1", "P2", "Q")},
    )
    print("Q:\n", out["Q"])
    print(f"epiline mean |slope| after rectification: {out['epiline_mean_abs_slope']:.5f}")
    print(f"artifacts written to {args.outdir}/")
    return 0


def cmd_match(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages

    out = stages.detect_match(
        args.pair,
        contrast_threshold=args.contrast_threshold,
        method="learned" if args.learned else "classical",
        model_checkpoint=(args.model or _default_learned_checkpoint())
        if args.learned else None,
    )
    print(f"keypoints: left={out['num_keypoints'][0]} right={out['num_keypoints'][1]}")
    print(f"good matches (ratio 0.75): {out['num_good_matches']}")
    if args.save:
        np.savez(args.save, **{k: v for k, v in out.items() if isinstance(v, np.ndarray)})
        print(f"saved matches to {args.save}")
    return 0


def cmd_train_features(args):
    """Self-supervised XFeat-style training (random crops + jitter,
    warmup-cosine schedule — models/xfeat_train.py)."""
    from stereo_reconstruction_cv_tpu.models import xfeat_train as XT

    folders = args.folder if args.folder else list(XT.DEFAULT_FOLDERS)
    try:
        XT.train(
            folders=folders,
            steps=args.steps,
            batch=args.batch,
            crop=args.size,
            lr=args.lr,
            output=args.output,
            max_images=args.max_images,
        )
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


def cmd_geometry(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages

    out = stages.estimate_geometry(
        args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
        method="learned" if getattr(args, "learned", False) else "classical",
        checkpoint=(getattr(args, "model", None) or _default_learned_checkpoint())
        if getattr(args, "learned", False) else None,
        cache=_stage_cache(args),
    )
    for k in ("Essential Matrix", "Rotation Matrix", "Translation Vector"):
        print(f"\n== {k} ==\n{out[k]}")
    print(f"\nmatches: {out['num_matches']}  F inliers: {out['num_inliers_F']}  E inliers: {out['num_inliers_E']}")
    return 0


def cmd_triangulate(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages
    from stereo_reconstruction_cv_tpu.io.ply import write_ply

    out = stages.triangulate_sparse(args.pair, camera_matrix=_load_K(args), baseline=args.baseline)
    pts = out["points"][out["valid"]]
    n = write_ply(args.output, pts)
    print(f"triangulated {n} points -> {args.output}")
    if args.viewer:
        from stereo_reconstruction_cv_tpu.io.viewer import write_html_viewer

        write_html_viewer(args.viewer, pts)
        print(f"viewer -> {args.viewer}")
    return 0


def cmd_report(args):
    """Full-pipeline HTML report: every stage's imagery + numbers in one
    self-contained page (the headless equivalent of the GUI's tab panes)."""
    import tempfile

    from stereo_reconstruction_cv_tpu.io.report import ReportBuilder
    from stereo_reconstruction_cv_tpu.pipeline import stages
    from stereo_reconstruction_cv_tpu.utils.draw import colormap_jet

    rb = ReportBuilder(f"stereo-tpu report — {args.pair}")
    K = _load_K(args)

    rb.section("Feature detection & matching (Tab 3)")
    m = stages.detect_match(args.pair, with_visualizations=True)
    rb.text(
        f"keypoints: left={m['num_keypoints'][0]} right={m['num_keypoints'][1]}; "
        f"good matches (ratio 0.75): {m['num_good_matches']}"
    )
    rb.images([(k, m[k]) for k in ("Left Keypoints", "Right Keypoints", "Good Matches") if k in m])

    rb.section("Rectification + geometry (Tabs 2/4)")
    # rectify_pair estimates the two-view geometry internally and returns
    # it — one robust F/E pass serves both report sections.
    r = stages.rectify_pair(args.pair, baseline=args.baseline, camera_matrix=K)
    g = r["geometry"]
    rb.pre(
        "Essential Matrix:\n%s\n\nRotation Matrix:\n%s\n\nTranslation Vector:\n%s\n\n"
        "matches %d  F inliers %d  E inliers %d"
        % (g["Essential Matrix"], g["Rotation Matrix"], g["Translation Vector"].ravel(),
           g["num_matches"], g["num_inliers_F"], g["num_inliers_E"])
    )
    rb.pre("Q:\n%s\nepiline mean |slope| after rectification: %.5f"
           % (r["Q"], r["epiline_mean_abs_slope"]))
    rb.images([(k, r[k]) for k in (
        "Left Epilines (before)", "Right Points (before)",
        "Left Epilines (after)", "Right Points (after)") if k in r])

    rb.section("Dense disparity (Tab 6)")
    disp = stages.disparity(r["left_rectified"], r["right_rectified"], ndisp=args.ndisp)
    rb.text(f"disparity range [{float(disp.min()):.2f}, {float(disp.max()):.2f}] "
            f"at {args.ndisp} disparities")
    rb.images([("Disparity (jet)", colormap_jet(np.asarray(disp)))])

    rb.section("3D reconstruction (point cloud)")
    pts = stages.reconstruct(disp, r["Q"])
    with tempfile.NamedTemporaryFile(suffix=".html", delete=False) as tf:
        n = stages.export_point_cloud(tf.name, pts, disp)
        rb.text(f"{n} valid points — drag to orbit, wheel to zoom")
        rb.viewer(tf.name)
    os.unlink(tf.name)

    # Per-stage observability table (SURVEY §5): the
    # same registry `--metrics` dumps, embedded in the report.
    from stereo_reconstruction_cv_tpu.utils.profiling import METRICS

    rb.section("Pipeline metrics")
    summary = METRICS.summary()
    rb.pre("\n".join(f"{k}: {summary[k]:.4f}" if isinstance(summary[k], float)
                     else f"{k}: {summary[k]}" for k in sorted(summary)))

    rb.write(args.output)
    print(f"report -> {args.output}")
    return 0


def cmd_view(args):
    """PLY -> standalone interactive HTML viewer (Open3D-window stand-in)."""
    from stereo_reconstruction_cv_tpu.io.ply import read_ply
    from stereo_reconstruction_cv_tpu.io.viewer import write_html_viewer

    pts, colors = read_ply(args.cloud)
    n = write_html_viewer(args.output, pts, colors, max_points=args.max_points)
    print(f"viewer with {n} points -> {args.output}")
    return 0


def cmd_disparity(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages
    from stereo_reconstruction_cv_tpu.io.image import load_stereo_pair, save_image
    from stereo_reconstruction_cv_tpu.utils.draw import colormap_jet

    imL, imR = load_stereo_pair(args.pair)
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp,
                            cache=_stage_cache(args))
    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "disparity.npy"), disp)
    save_image(os.path.join(args.outdir, "disparity_jet.png"), colormap_jet(disp))
    print(f"disparity range [{disp.min():.2f}, {disp.max():.2f}] -> {args.outdir}/")
    return 0


def cmd_reconstruct(args):
    from stereo_reconstruction_cv_tpu.pipeline import stages
    from stereo_reconstruction_cv_tpu.io.image import load_stereo_pair, load_rgb

    imL, imR = load_stereo_pair(args.pair)
    cache = _stage_cache(args)
    if args.rectification:
        Q = np.load(args.rectification)["Q"]
    else:
        rect = stages.rectify_pair(args.pair, baseline=args.baseline, camera_matrix=_load_K(args),
                                   with_visualizations=False, cache=cache)
        imL, imR = rect["left_rectified"], rect["right_rectified"]
        Q = rect["Q"]
    disp = stages.disparity(imL, imR, ndisp=args.ndisp, mindis=args.mindisp, cache=cache)
    pts = stages.reconstruct(disp, Q)
    colors = None
    p1 = os.path.join(args.pair, "img1.jpg")
    if os.path.exists(p1):
        rgb = load_rgb(p1)
        if rgb.shape[:2] == disp.shape:
            colors = rgb
    n = stages.export_point_cloud(args.output, pts, disp, colors)
    print(f"wrote {n} points -> {args.output}")
    if args.viewer:
        stages.export_point_cloud(args.viewer, pts, disp, colors)
        print(f"viewer -> {args.viewer}")
    return 0


def cmd_bench(args):
    # The benchmark suite lives in the package so the installed console
    # script works from any directory (repo-root bench.py is a thin shim).
    from stereo_reconstruction_cv_tpu import benchmarks

    return benchmarks.main(getattr(args, "configs", None) or None)


def main(argv=None):
    # NOTE: x64 is deliberately NOT enabled here. Geometry/calibration
    # solves route to the host CPU backend (pipeline.stages._on_host_cpu)
    # where f32 LAPACK is already accurate (verified against the d3
    # anchors).
    from stereo_reconstruction_cv_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="stereo-tpu", description=__doc__)
    p.add_argument("--metrics", default=None, metavar="OUT.json",
                   help="dump per-stage timings + counts (utils/profiling "
                        "Metrics registry) to this JSON file after the verb")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("calibrate", help="chessboard camera calibration (Tab 1)")
    c.add_argument("folder")
    c.add_argument("--chessboard", type=int, nargs=2, default=[9, 7])
    c.add_argument("--save", default=None)
    c.set_defaults(fn=cmd_calibrate)

    r = sub.add_parser("rectify", help="two-view rectification (Tab 2)")
    r.add_argument("pair")
    r.add_argument("--baseline", type=float, default=0.1)
    r.add_argument("--calibration", default=None)
    r.add_argument("--undistort", action="store_true",
                   help="apply the calibration's distortion in the remap "
                        "(the reference passes dist=None; opt in)")
    r.add_argument("--outdir", default="rectify_out")
    r.add_argument("--cache", nargs="?", const=".stereo_tpu_cache", default=None,
                   metavar="DIR", help="persist/reuse stage results (StageCache)")
    r.set_defaults(fn=cmd_rectify)

    scal = sub.add_parser("stereo-calibrate", help="two-camera rig calibration [branch]")
    scal.add_argument("folder1")
    scal.add_argument("folder2")
    scal.add_argument("--chessboard", type=int, nargs=2, default=[9, 7])
    scal.add_argument("--save", default=None)
    scal.set_defaults(fn=cmd_stereo_calibrate)

    m = sub.add_parser("match", help="feature detect/match (Tabs 3/7)")
    m.add_argument("pair")
    m.add_argument("--contrast-threshold", type=float, default=0.04)
    m.add_argument("--save", default=None)
    m.add_argument("--learned", action="store_true", help="XFeat-style matcher (Tab 7)")
    m.add_argument("--model", default=None, help="checkpoint (.npz) for --learned")
    m.set_defaults(fn=cmd_match)

    tf = sub.add_parser("train-features", help="self-supervised XFeat training")
    tf.add_argument("folder", nargs="*",
                    help="image folders (default: bundled calib + d1-d3)")
    tf.add_argument("--steps", type=int, default=5000)
    tf.add_argument("--size", type=int, default=256, help="crop size")
    tf.add_argument("--batch", type=int, default=16)
    tf.add_argument("--lr", type=float, default=2e-3)
    tf.add_argument("--max-images", type=int, default=64)
    tf.add_argument("--output", default="xfeat_ckpt")
    tf.set_defaults(fn=cmd_train_features)

    g = sub.add_parser("geometry", help="E/R/T estimation (Tab 4)")
    g.add_argument("pair")
    g.add_argument("--baseline", type=float, default=0.1)
    g.add_argument("--calibration", default=None)
    g.add_argument("--learned", action="store_true", help="XFeat-style matcher")
    g.add_argument("--model", default=None, help="checkpoint (.npz) for --learned")
    g.add_argument("--cache", nargs="?", const=".stereo_tpu_cache", default=None,
                   metavar="DIR", help="persist/reuse stage results (StageCache)")
    g.set_defaults(fn=cmd_geometry)

    t = sub.add_parser("triangulate", help="sparse reconstruction (Tab 5)")
    t.add_argument("pair")
    t.add_argument("--baseline", type=float, default=0.1)
    t.add_argument("--calibration", default=None)
    t.add_argument("--output", default="sparse_cloud.ply")
    t.add_argument("--viewer", default=None, help="also write an HTML viewer")
    t.set_defaults(fn=cmd_triangulate)

    d = sub.add_parser("disparity", help="dense disparity (Tab 6)")
    d.add_argument("pair")
    d.add_argument("--ndisp", type=int, default=16)
    d.add_argument("--mindisp", type=int, default=0)
    d.add_argument("--outdir", default="disparity_out")
    d.add_argument("--cache", nargs="?", const=".stereo_tpu_cache", default=None,
                   metavar="DIR", help="persist/reuse stage results (StageCache)")
    d.set_defaults(fn=cmd_disparity)

    rc = sub.add_parser("reconstruct", help="pair -> dense point cloud (Tab 6)")
    rc.add_argument("pair")
    rc.add_argument("--baseline", type=float, default=0.1)
    rc.add_argument("--calibration", default=None)
    rc.add_argument("--rectification", default=None, help="rectification.npz with Q")
    rc.add_argument("--ndisp", type=int, default=64)
    rc.add_argument("--mindisp", type=int, default=0)
    rc.add_argument("--output", default="point_cloud.ply")
    rc.add_argument("--viewer", default=None, help="also write an HTML viewer")
    rc.add_argument("--cache", nargs="?", const=".stereo_tpu_cache", default=None,
                   metavar="DIR", help="persist/reuse stage results (StageCache)")
    rc.set_defaults(fn=cmd_reconstruct)

    rp = sub.add_parser("report", help="full-pipeline HTML report (all tabs)")
    rp.add_argument("pair")
    rp.add_argument("--baseline", type=float, default=0.1)
    rp.add_argument("--calibration", default=None)
    rp.add_argument("--ndisp", type=int, default=64)
    rp.add_argument("--output", default="stereo_report.html")
    rp.set_defaults(fn=cmd_report)

    v = sub.add_parser("view", help="PLY -> standalone HTML viewer")
    v.add_argument("cloud")
    v.add_argument("output", nargs="?", default="cloud_viewer.html")
    v.add_argument("--max-points", type=int, default=2_000_000)
    v.set_defaults(fn=cmd_view)

    b = sub.add_parser("bench", help="run the benchmark suite")
    b.add_argument("configs", nargs="*", type=int,
                   help="BASELINE config numbers (default: all five)")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    _validate_reference_ranges(args)
    rc = args.fn(args)
    if getattr(args, "metrics", None):
        from stereo_reconstruction_cv_tpu.utils.profiling import METRICS

        with open(args.metrics, "w") as f:
            f.write(METRICS.dump() + "\n")
        print(f"metrics -> {args.metrics}")
    return rc


def _validate_reference_ranges(args) -> None:
    """Input-validation parity with the GUI: bad values
    warn and fall back to the reference defaults instead of erroring.

    - baseline must be a positive float, else 0.1 (gui.py:465-472)
    - contrast threshold must lie in [0, 0.1], else 0.04 (gui.py:546-553)"""
    if getattr(args, "baseline", None) is not None and args.baseline <= 0:
        print(
            f"Invalid baseline value: {args.baseline}. Baseline must be "
            "positive. Using default (0.1).",
            file=sys.stderr,
        )
        args.baseline = 0.1
    ct = getattr(args, "contrast_threshold", None)
    if ct is not None and not (0 <= ct <= 0.1):
        print(
            f"Invalid contrast threshold: {ct}. Contrast threshold must be "
            "between 0 and 0.1. Using default (0.04).",
            file=sys.stderr,
        )
        args.contrast_threshold = 0.04


if __name__ == "__main__":
    sys.exit(main())
