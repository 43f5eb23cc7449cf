"""Pipeline stages mirroring the reference's function surface (SURVEY §2.1).

Each stage is the device equivalent of a reference entry point:

  calibrate            <- cam_calib (gui.py:27-75, ipynb cell 1)
  detect_match         <- feat_detect_match (gui.py:211-261)
  estimate_geometry    <- stereo_geometry_estimation (gui.py:263-322)
  rectify_pair         <- stereo_rect (gui.py:92-209, cells 5-8)
  disparity            <- compute_disparity_map (cell 10)
  reconstruct          <- reconstruct_3D (cell 11)
  triangulate_sparse   <- triangulatePoints path (README.md:29 [branch])
  export_point_cloud   <- visualize/write_point_cloud (cells 12-13)

Folder conventions preserved: calibration folders glob *.jpg; a stereo pair
is img1.jpg/img2.jpg. Stage outputs are plain dataclass-like dicts of
arrays (GUI-free; artifacts instead of Tk windows). All heavy math runs
jitted on the accelerator; stages accept/return numpy at the boundary.

Documented behavior quirks of the reference preserved or fixed (SURVEY §7
"quirks"): the user-supplied baseline seeds T but recoverPose returns a
unit-norm T (gui.py:108 vs :145) — we expose both `baseline` (metric) and
the unit T, and scale Q by the metric baseline when provided, which is the
consciously-fixed behavior. Preserved as-is: the reference builds Q from a
POSITIVE-x translation (cell 5: T=[baseline,0,0]; recoverPose also yields
T_x>0 on d3), which makes reprojected Z negative (a mirrored but metrically
correct cloud) — we reproduce this so Q/cloud outputs match the reference;
negate T for the canonical-orientation cloud.
"""

from __future__ import annotations

import functools

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stereo_reconstruction_cv_tpu import config as cfg_mod
from stereo_reconstruction_cv_tpu.errors import error_dict
from stereo_reconstruction_cv_tpu.calib import chessboard as CB
from stereo_reconstruction_cv_tpu.calib import zhang as Z
from stereo_reconstruction_cv_tpu.io import image as IO
from stereo_reconstruction_cv_tpu.io import ply as PLY
from stereo_reconstruction_cv_tpu.ops import disparity as DP
from stereo_reconstruction_cv_tpu.ops import epipolar as EP
from stereo_reconstruction_cv_tpu.ops import features as FT
from stereo_reconstruction_cv_tpu.ops import geometry as G
from stereo_reconstruction_cv_tpu.ops import matching as M
from stereo_reconstruction_cv_tpu.ops import rectify as RC
from stereo_reconstruction_cv_tpu.ops import robust as RB


def _observed(stage: str):
    """Per-stage observability (SURVEY §5): every public
    stage records its wall-clock into the process-global Metrics registry
    (utils/profiling.py), and scalar diagnostics from dict-returning stages
    (match counts, inlier counts, residuals — the numbers the reference
    prints, gui.py:228-229, 242; cell 6 +42-44) land as '<stage>/<key>'
    values. `cli --metrics out.json` dumps the registry after any verb."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from stereo_reconstruction_cv_tpu.utils.profiling import (
                METRICS,
                stage_timer,
            )

            with stage_timer(stage):
                out = fn(*args, **kwargs)
            if isinstance(out, dict):
                for k, v in out.items():
                    if isinstance(v, (bool, int, float)):
                        METRICS.record(f"{stage}/{k}", v)
                    elif isinstance(v, tuple) and all(
                        isinstance(x, (int, float)) for x in v
                    ):
                        for i, x in enumerate(v):
                            METRICS.record(f"{stage}/{k}_{i}", x)
            return out

        return wrapper

    return deco


def default_camera_matrix(cfg: cfg_mod.RectifyConfig = cfg_mod.DEFAULT.rectify) -> np.ndarray:
    """The reference's fallback K (gui.py:93-94, 264-265)."""
    return np.array(
        [[cfg.default_fx, 0, cfg.default_cx], [0, cfg.default_fy, cfg.default_cy], [0, 0, 1.0]]
    )


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

@_observed("calibrate")
def calibrate(
    folder: str,
    chessboard: Tuple[int, int] = (9, 7),
    cache=None,
    save_corner_annotations: bool = False,
    annotation_dir: str = "chessboard_corners",
) -> Dict:
    """cam_calib parity: glob *.jpg, find chessboards, calibrate.

    Returns dict with K, dist, per-image detections, reprojection errors,
    and the reference's result-tuple format under 'results'.
    save_corner_annotations mirrors the reference flag (gui.py:41, notebook
    True): writes corner-overlay JPGs into annotation_dir."""
    from stereo_reconstruction_cv_tpu.pipeline.cache import file_fingerprint

    files = IO.glob_calibration_images(folder)
    if not files:
        return error_dict(f"no *.jpg calibration images in {folder!r}", "data")
    key = {"files": [file_fingerprint(f) for f in files]}
    if cache is not None:
        hit = cache.load("calibrate", key)
        if hit is not None:
            out = {k: v for k, v in hit.items()}
            # Scalars round-trip as 0-d arrays; restore native types.
            for k in ("rms", "mean_error"):
                if k in out:
                    out[k] = float(out[k])
            if "num_images" in out:
                out["num_images"] = int(out["num_images"])
            out["results"] = _calib_results_tuple(out)
            return out
    cols, rows = chessboard
    pts, used = [], []
    for f in files:
        gray = IO.load_gray(f)
        found, corners = CB.find_chessboard_corners(jnp.asarray(gray), cols, rows)
        if found:
            pts.append(np.asarray(corners))
            used.append(f)
            if save_corner_annotations:
                import os

                from stereo_reconstruction_cv_tpu.utils import draw as DR

                os.makedirs(annotation_dir, exist_ok=True)
                vis = DR.draw_keypoints(gray, np.asarray(corners))
                IO.save_image(
                    os.path.join(annotation_dir, os.path.basename(f)), vis
                )
    if len(pts) < 3:
        return error_dict(f"chessboard found in only {len(pts)} images", "calibration")
    obj = np.asarray(Z.build_object_points(cols, rows))
    H, W = IO.load_gray(used[0]).shape
    res = Z.calibrate_camera(
        jnp.asarray(obj), jnp.asarray(np.stack(pts), dtype=jnp.float64), (W, H)
    )
    out = {
        "K": np.asarray(res.K),
        "dist": np.asarray(res.dist),
        "rvecs": np.asarray(res.rvecs),
        "tvecs": np.asarray(res.tvecs),
        "rms": float(res.rms),
        "mean_error": float(res.mean_error),
        "per_view_error": np.asarray(res.per_view_error),
        "num_images": len(pts),
    }
    if cache is not None:
        cache.save(
            "calibrate",
            key,
            {
                k: np.asarray(v)
                for k, v in out.items()
                if isinstance(v, (np.ndarray, float, int))
            },
        )
    out["results"] = _calib_results_tuple(out)
    return out


def _calib_results_tuple(out):
    """The reference's return shape (gui.py:75)."""
    return [
        ("Camera Matrix", out["K"]),
        ("Distortion Parameters", out["dist"]),
        ("Reprojection Error", float(out["mean_error"])),
    ]


@_observed("calibrate_stereo_rig")
def calibrate_stereo_rig(
    folder1: str,
    folder2: str,
    chessboard: Tuple[int, int] = (9, 7),
) -> Dict:
    """Two-camera rig calibration from synchronized chessboard folders
    (the stereo-camera branch workflow, README.md:59-76): detects boards in
    both cameras' images (paired by sorted filename), keeps views seen by
    BOTH, and jointly calibrates K1/dist1/K2/dist2/R/T."""
    from stereo_reconstruction_cv_tpu.calib import stereo as SCAL

    f1 = IO.glob_calibration_images(folder1)
    f2 = IO.glob_calibration_images(folder2)
    if not f1 or not f2 or len(f1) != len(f2):
        return error_dict(f"need matching image counts ({len(f1)} vs {len(f2)})", "data")
    cols, rows = chessboard
    p1, p2 = [], []
    size = None
    for a, b in zip(f1, f2):
        g1 = IO.load_gray(a)
        g2 = IO.load_gray(b)
        size = (g1.shape[1], g1.shape[0])
        ok1, c1 = CB.find_chessboard_corners(jnp.asarray(g1), cols, rows)
        ok2, c2 = CB.find_chessboard_corners(jnp.asarray(g2), cols, rows)
        if ok1 and ok2:
            p1.append(np.asarray(c1))
            p2.append(np.asarray(c2))
    if len(p1) < 3:
        return error_dict(f"board found in both views for only {len(p1)} pairs", "calibration")
    obj = np.asarray(Z.build_object_points(cols, rows))
    with _on_host_cpu():
        res = SCAL.calibrate_stereo(
            jnp.asarray(obj), jnp.asarray(np.stack(p1)), jnp.asarray(np.stack(p2)), size
        )
    return {
        "K1": np.asarray(res.K1), "dist1": np.asarray(res.dist1),
        "K2": np.asarray(res.K2), "dist2": np.asarray(res.dist2),
        "R": np.asarray(res.R), "T": np.asarray(res.T),
        "rms": float(res.rms), "num_pairs": len(p1),
    }


# ---------------------------------------------------------------------------
# Features & matching
# ---------------------------------------------------------------------------

@_observed("detect_match")
def detect_match(
    folder_or_pair,
    contrast_threshold: float = 0.04,
    ratio: float = 0.75,
    max_keypoints: int = 2048,
    method: str = "classical",
    model_checkpoint: str | None = None,
    with_visualizations: bool = False,
) -> Dict:
    """feat_detect_match parity (gui.py:211-261): keypoints, descriptors,
    kNN matches + Lowe ratio (0.75 on this inspection path, gui.py:241).

    method='learned' uses the XFeat-style network (the reference's Tab 7,
    README.md:109-110 [branch]); pass a checkpoint (.npz) from
    `cli train-features` for trained weights."""
    imL, imR = _load_pair(folder_or_pair)
    if method == "learned":
        fl, fr = _learned_features_pair(imL, imR, max_keypoints, model_checkpoint)
        mres = M.match_learned(
            fl.descriptors.astype(jnp.float32),
            fr.descriptors.astype(jnp.float32),
            fl.mask, fr.mask,
        )
    else:
        fl = FT.detect_and_describe(jnp.asarray(imL), max_keypoints, contrast_threshold)
        fr = FT.detect_and_describe(jnp.asarray(imR), max_keypoints, contrast_threshold)
        mres = M.knn2_match(
            fl.descriptors.astype(jnp.float32),
            fr.descriptors.astype(jnp.float32),
            fl.mask, fr.mask, ratio=ratio,
        )
    out = {
        "keypoints1": np.asarray(fl.keypoints),
        "keypoints2": np.asarray(fr.keypoints),
        "descriptors1": np.asarray(fl.descriptors),
        "descriptors2": np.asarray(fr.descriptors),
        "num_keypoints": (int(fl.mask.sum()), int(fr.mask.sum())),
        "match_indices": np.asarray(mres.indices),
        "match_mask": np.asarray(mres.mask),
        "num_good_matches": int(mres.mask.sum()),
    }
    if with_visualizations:
        # The reference tab renders 4 images: keypoints L/R, all matches,
        # good matches (gui.py:244-248), resized for display (:251-254).
        from stereo_reconstruction_cv_tpu.utils import draw as DR

        kl = out["keypoints1"][np.asarray(fl.mask)]
        kr = out["keypoints2"][np.asarray(fr.mask)]
        good = [
            (i, int(out["match_indices"][i]))
            for i in np.nonzero(out["match_mask"])[0]
        ]
        all_m = [(i, int(out["match_indices"][i])) for i in range(len(out["match_indices"]))
                 if bool(fl.mask[i])]
        out["Left Keypoints"] = DR.resize_nearest(DR.draw_keypoints(imL, kl[:500]), (640, 360))
        out["Right Keypoints"] = DR.resize_nearest(DR.draw_keypoints(imR, kr[:500]), (640, 360))
        out["All Matches"] = DR.resize_nearest(
            DR.draw_matches(imL, out["keypoints1"], imR, out["keypoints2"], all_m), (1280, 360)
        )
        out["Good Matches"] = DR.resize_nearest(
            DR.draw_matches(imL, out["keypoints1"], imR, out["keypoints2"], good), (1280, 360)
        )
    return out


def _load_pair(folder_or_pair):
    if isinstance(folder_or_pair, str):
        return IO.load_stereo_pair(folder_or_pair)
    return folder_or_pair


def _pair_cache_key(folder_or_pair, **params) -> Dict:
    """Cache key for a stereo-pair stage: img1/img2 file fingerprints when
    given a folder (cheap stat), content hashes when given arrays, plus
    every parameter that changes the stage's output (SURVEY §5 checkpoint
    row: any stage can restart from its persisted npz)."""
    import hashlib
    import os

    from stereo_reconstruction_cv_tpu.pipeline.cache import file_fingerprint

    if isinstance(folder_or_pair, str):
        fps = []
        for name in ("img1.jpg", "img2.jpg"):
            p = os.path.join(folder_or_pair, name)
            fps.append(file_fingerprint(p) if os.path.exists(p) else name)
        key = {"pair": fps}
    else:
        imL, imR = folder_or_pair
        key = {
            "pair": [
                hashlib.sha1(np.ascontiguousarray(x)).hexdigest()
                for x in (np.asarray(imL), np.asarray(imR))
            ]
        }
    key.update(params)
    return key


_XFEAT_CACHE = {}


def _xfeat_model(checkpoint: str | None):
    """Model + params (checkpoint or fresh init), cached per checkpoint.

    The params template always initializes at a FIXED tiny shape: the
    convnet's parameter shapes are input-size independent, so one
    shape-independent init program serves every working resolution."""
    from stereo_reconstruction_cv_tpu.models import xfeat as XF

    key = ("model", checkpoint)
    if key not in _XFEAT_CACHE:
        model = XF.XFeatNet()
        state, _ = XF.create_train_state(jax.random.PRNGKey(0), model, (64, 96))
        params = state.params
        if checkpoint:
            from stereo_reconstruction_cv_tpu.models import checkpoint as CK

            params = CK.load_params(checkpoint, like=params)
        _XFEAT_CACHE[key] = (model, params)
    return _XFEAT_CACHE[key]


def _learned_features(img, max_keypoints: int, checkpoint: str | None):
    """XFeat-style detection; weights from a checkpoint or fresh init.
    H, W are cropped to multiples of the 8-px cell."""
    from stereo_reconstruction_cv_tpu.models import xfeat as XF

    model, params = _xfeat_model(checkpoint)
    H0, W0 = img.shape[0] // 8 * 8, img.shape[1] // 8 * 8
    return XF.detect(params, model, jnp.asarray(img[:H0, :W0]), max_keypoints)


def _learned_features_pair(imL, imR, max_keypoints: int, checkpoint: str | None):
    """Pair detection with one batched net forward (models.xfeat.detect_pair)."""
    from stereo_reconstruction_cv_tpu.models import xfeat as XF

    model, params = _xfeat_model(checkpoint)
    H0, W0 = imL.shape[0] // 8 * 8, imL.shape[1] // 8 * 8
    if imR.shape[:2] != imL.shape[:2]:
        return (
            _learned_features(imL, max_keypoints, checkpoint),
            _learned_features(imR, max_keypoints, checkpoint),
        )
    return XF.detect_pair(
        params, model, jnp.asarray(imL[:H0, :W0]), jnp.asarray(imR[:H0, :W0]),
        max_keypoints,
    )


import contextlib


def _host_cpu_device():
    # Small irregular solves (robust geometry, eigen/SVD stages) run on the
    # host CPU backend when one is registered: the data is tiny, and CPU
    # LAPACK is more accurate than an f32 iterative eigh. Dense kernels
    # stay on the accelerator.
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


@contextlib.contextmanager
def _on_host_cpu():
    dev = _host_cpu_device()
    if dev is None:
        yield
        return
    with jax.default_device(dev):
        yield


def _geometry_ctx():
    """Device policy for the sparse/geometry solves.

    Default ('device'): run ON the accelerator — the whole stack is
    Hartley-normalized and decomposition-free (ops/linalg.py inverse
    iteration + analytic 3x3 instead of LAPACK lowerings), f32-safe, and
    validated against the d3 notebook anchors (max |R-I| 0.0397 vs
    anchor ~0.040). Set STEREO_GEOMETRY_DEVICE=host for the
    round-1 conservative host-CPU path (CPU LAPACK via the same code)."""
    import os

    pol = os.environ.get("STEREO_GEOMETRY_DEVICE", "device")
    if pol == "host":
        return _on_host_cpu()
    return contextlib.nullcontext()


def _downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-average downscale by an integer factor."""
    H, W = img.shape
    img = img[: H - H % factor, : W - W % factor]
    return (
        img.reshape(H // factor, factor, W // factor, factor)
        .astype(np.float32)
        .mean((1, 3))
        .astype(np.uint8)
    )


def _match_for_geometry(imL, imR, cfg: cfg_mod.MatchConfig, max_dim: int = 2048,
                        method: str = "classical", checkpoint: str | None = None):
    """Detect+match for the geometry path. Large frames are detected at a
    reduced scale (keypoint coords scaled back) — detection response and
    descriptors are scale-normalized, and sub-pixel precision at 2K is
    ample for robust F/E estimation.

    method='learned' swaps in the XFeat-style net (Tab 7 semantics) —
    correspondences then feed the identical robust F/E + pose path.

    Runs under full f32 matmul/conv precision: reduced-precision matmuls
    (TF32 on a GPU) degrade descriptor distances and the robust solvers'
    normal-equation products enough to corrupt the pose."""
    imL = np.asarray(imL)
    imR = np.asarray(imR)
    factor = max(1, int(np.ceil(max(imL.shape) / max_dim)))
    dL = _downscale(imL, factor) if factor > 1 else imL
    dR = _downscale(imR, factor) if factor > 1 else imR
    with _geometry_ctx(), jax.default_matmul_precision("highest"):
        if method == "learned":
            fl, fr = _learned_features_pair(dL, dR, cfg.max_keypoints, checkpoint)
            # Learned dense-grid descriptors: mutual NN + cosine gate
            # (Lowe's ratio starves them — see ops.matching.match_learned).
            mres = M.match_learned(
                fl.descriptors.astype(jnp.float32),
                fr.descriptors.astype(jnp.float32),
                fl.mask, fr.mask, min_cossim=cfg.learned_min_cossim,
            )
        else:
            fl = FT.detect_and_describe(jnp.asarray(dL), cfg.max_keypoints, cfg.contrast_threshold)
            fr = FT.detect_and_describe(jnp.asarray(dR), cfg.max_keypoints, cfg.contrast_threshold)
            mres = M.knn2_match(
                fl.descriptors.astype(jnp.float32),
                fr.descriptors.astype(jnp.float32),
                fl.mask, fr.mask, ratio=cfg.ratio_geometry, mutual=True,
            )
    p1, p2, mask = M.gather_correspondences(fl.keypoints, fr.keypoints, mres)
    s = float(factor)
    p1 = p1.astype(jnp.float64) * s
    p2 = p2.astype(jnp.float64) * s
    if method == "learned" and cfg.lk_refine:
        # Learned keypoints localize to ~0.5-1 px (8-px heatmap cells),
        # starving the fixed 1.0 px E-RANSAC gate (gui.py:142). LK-align
        # each right patch to its left patch at FULL resolution: the
        # refined pair satisfies the epipolar constraint wherever the
        # left point happens to sit (ops/refine.py).
        from stereo_reconstruction_cv_tpu.ops.refine import refine_matches_lk

        with _geometry_ctx():
            p2r, _ = refine_matches_lk(
                jnp.asarray(imL), jnp.asarray(imR),
                p1.astype(jnp.float32), p2.astype(jnp.float32),
                win=cfg.lk_win, iters=cfg.lk_iters,
            )
        p2 = p2r.astype(jnp.float64)
    return p1, p2, mask, factor


# ---------------------------------------------------------------------------
# Two-view geometry
# ---------------------------------------------------------------------------

@_observed("estimate_geometry")
def estimate_geometry(
    folder_or_pair,
    baseline: float = 0.1,
    camera_matrix: Optional[np.ndarray] = None,
    seed: int = 0,
    pipeline_cfg: cfg_mod.PipelineConfig = cfg_mod.DEFAULT,
    method: str = "classical",
    checkpoint: str | None = None,
    cache=None,
) -> Dict:
    """stereo_geometry_estimation parity (gui.py:263-322): SIFT-sem match
    (ratio 0.7) -> F (LMedS) -> E (RANSAC p=.999 thr=1px) -> recoverPose.

    method='learned' uses the XFeat-style matcher for correspondences
    (Tab 7 geometry path, README.md:109-110 [branch]).

    cache: optional pipeline.cache.StageCache — results keyed on the
    pair's content + K/seed/method persist across processes (SURVEY §5).

    Returns the reference's dict {"Essential Matrix", "Rotation Matrix",
    "Translation Vector"} plus F, inlier masks and diagnostics."""
    imL, imR = _load_pair(folder_or_pair)
    K = np.asarray(camera_matrix) if camera_matrix is not None else default_camera_matrix()
    ckey = None
    if cache is not None:
        ckey = _pair_cache_key(
            folder_or_pair, K=K.tolist(), seed=seed, method=method,
            checkpoint=checkpoint, baseline=baseline,
        )
        hit = cache.load("geometry", ckey)
        if hit is not None:
            out = dict(hit)
            out["baseline"] = float(out["baseline"])
            for k in ("num_matches", "num_inliers_F", "num_inliers_E"):
                out[k] = int(out[k])
            return out
    p1, p2, mask, det_factor = _match_for_geometry(
        imL, imR, pipeline_cfg.match, method=method, checkpoint=checkpoint
    )
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    with _geometry_ctx(), jax.default_matmul_precision("highest"):
        fres = RB.find_fundamental(
            keys[0], p1, p2, mask=mask,
            method=pipeline_cfg.robust.f_method,
            num_hypotheses=pipeline_cfg.robust.num_hypotheses,
        )
        # Keypoint noise scales with the detection downscale factor; the
        # RANSAC threshold must too or inliers get starved on 4K frames.
        eres = RB.find_essential(
            keys[1], p1, p2, jnp.asarray(K), mask=fres.inlier_mask,
            threshold_px=pipeline_cfg.robust.e_threshold_px * det_factor,
            num_hypotheses=2 * pipeline_cfg.robust.num_hypotheses,
        )
        n1 = EP.pixel_to_normalized(p1, jnp.asarray(K))
        n2 = EP.pixel_to_normalized(p2, jnp.asarray(K))
        R, T, pose_mask, votes = EP.recover_pose(
            eres.model, n1, n2, weights=eres.inlier_mask.astype(n1.dtype)
        )
    out = {
        "Essential Matrix": np.asarray(eres.model),
        "Rotation Matrix": np.asarray(R),
        "Translation Vector": np.asarray(T).reshape(3, 1),
        "F": np.asarray(fres.model),
        "baseline": baseline,  # metric scale (unit-norm T quirk, see module doc)
        "num_matches": int(mask.sum()),
        "num_inliers_F": int(fres.num_inliers),
        "num_inliers_E": int(eres.num_inliers),
        "pts1": np.asarray(p1),
        "pts2": np.asarray(p2),
        "inlier_mask": np.asarray(eres.inlier_mask),
    }
    if cache is not None:
        cache.save("geometry", ckey, out)
    return out


# ---------------------------------------------------------------------------
# Rectification
# ---------------------------------------------------------------------------

@_observed("rectify_pair")
def rectify_pair(
    folder_or_pair,
    baseline: float = 0.1,
    camera_matrix: Optional[np.ndarray] = None,
    dist: Optional[np.ndarray] = None,
    alpha: float = 1.0,
    seed: int = 0,
    with_visualizations: bool = True,
    pipeline_cfg: cfg_mod.PipelineConfig = cfg_mod.DEFAULT,
    cache=None,
) -> Dict:
    """stereo_rect parity (gui.py:92-209): estimate geometry, rectify with
    alpha=1.0, fused remap both images, re-verify epipolar geometry on the
    rectified pair; optional before/after epiline visualizations.

    `dist` (5-coeff) enables undistortion in the fused remap — the
    reference passes dist=None even when calibration produced one (cell 3
    wrapper), which we support but don't force.

    cache: optional StageCache — the full rectification output (including
    the nested geometry dict, flattened to 'geo *' npz keys) persists
    keyed on pair content + K/dist/alpha/seed (SURVEY §5)."""
    imL, imR = _load_pair(folder_or_pair)
    K = np.asarray(camera_matrix) if camera_matrix is not None else default_camera_matrix()
    dj = None if dist is None else jnp.asarray(dist)
    ckey = None
    if cache is not None:
        ckey = _pair_cache_key(
            folder_or_pair, K=K.tolist(),
            dist=None if dist is None else np.asarray(dist).tolist(),
            alpha=alpha, seed=seed, baseline=baseline,
            vis=bool(with_visualizations),
        )
        hit = cache.load("rectify", ckey)
        if hit is not None:
            out = {k: v for k, v in hit.items() if not k.startswith("geo ")}
            geo = {k[len("geo "):]: v for k, v in hit.items() if k.startswith("geo ")}
            geo["baseline"] = float(geo["baseline"])
            for k in ("num_matches", "num_inliers_F", "num_inliers_E"):
                geo[k] = int(geo[k])
            out["geometry"] = geo
            out["epiline_mean_abs_slope"] = float(out["epiline_mean_abs_slope"])
            return out
    geo = estimate_geometry((imL, imR), baseline, K, seed, pipeline_cfg)
    R = jnp.asarray(geo["Rotation Matrix"])
    T = jnp.asarray(geo["Translation Vector"]).reshape(3) * baseline
    H, W = imL.shape
    with _on_host_cpu():  # tiny closed-form math; f64-capable on host
        rr = RC.stereo_rectify(
            jnp.asarray(K), dj, jnp.asarray(K), dj, (W, H), R, T, alpha=alpha
        )
    left_rect = np.asarray(
        RC.rectify_remap(jnp.asarray(imL), jnp.asarray(K), dj, rr.R1, rr.P1)
    )
    right_rect = np.asarray(
        RC.rectify_remap(jnp.asarray(imR), jnp.asarray(K), dj, rr.R2, rr.P2)
    )
    out = {
        "left_rectified": left_rect,
        "right_rectified": right_rect,
        "R1": np.asarray(rr.R1), "R2": np.asarray(rr.R2),
        "P1": np.asarray(rr.P1), "P2": np.asarray(rr.P2),
        "Q": np.asarray(rr.Q),
        "geometry": geo,
    }
    # Verification pass: re-match on the rectified pair, recompute F, check
    # the epilines are horizontal (the reference's visual check, gui.py:167-195).
    p1r, p2r, maskr, _ = _match_for_geometry(left_rect, right_rect, pipeline_cfg.match)
    fres = RB.find_fundamental(jax.random.PRNGKey(seed + 1), p1r, p2r, mask=maskr)
    lines = G.compute_epilines(p1r, fres.model, 1)
    slopes = np.abs(np.asarray(lines[:, 0] / (jnp.abs(lines[:, 1]) + 1e-9)))
    out["F_rectified"] = np.asarray(fres.model)
    out["epiline_mean_abs_slope"] = float(
        np.mean(slopes[np.asarray(fres.inlier_mask)]) if fres.inlier_mask.any() else np.inf
    )
    if with_visualizations:
        from stereo_reconstruction_cv_tpu.utils import draw as DR

        inl = np.asarray(geo["inlier_mask"])
        sel = np.nonzero(inl)[0][:30]
        lines_before = np.asarray(
            G.compute_epilines(jnp.asarray(geo["pts2"][sel]), jnp.asarray(geo["F"]), 2)
        )
        vis1, vis2 = DR.draw_epilines(imL, imR, lines_before, geo["pts1"][sel], geo["pts2"][sel])
        selr = np.nonzero(np.asarray(fres.inlier_mask))[0][:30]
        lines_after = np.asarray(G.compute_epilines(p2r[selr], fres.model, 2))
        vis3, vis4 = DR.draw_epilines(
            left_rect, right_rect, lines_after, np.asarray(p1r)[selr], np.asarray(p2r)[selr]
        )
        out.update(
            {
                "Left Epilines (before)": vis1,
                "Right Points (before)": vis2,
                "Left Epilines (after)": vis3,
                "Right Points (after)": vis4,
            }
        )
    if cache is not None:
        flat = {k: v for k, v in out.items() if k != "geometry"}
        flat.update({f"geo {k}": np.asarray(v) for k, v in geo.items()})
        cache.save("rectify", ckey, flat)
    return out


# ---------------------------------------------------------------------------
# Dense reconstruction
# ---------------------------------------------------------------------------

@_observed("disparity")
def disparity(imgL, imgR, ndisp: int = 16, mindis: int = 0, cache=None) -> np.ndarray:
    """compute_disparity_map parity (cell 10): float map, /16 semantics,
    non-positive zeroed. cache: optional StageCache keyed on the input
    image content + SGBM parameters."""
    ckey = None
    if cache is not None:
        ckey = _pair_cache_key((imgL, imgR), ndisp=ndisp, mindis=mindis)
        hit = cache.load("disparity", ckey)
        if hit is not None:
            return hit["disparity"]
    disp = np.asarray(
        DP.compute_disparity_map(jnp.asarray(imgL), jnp.asarray(imgR), ndisp, mindis)
    )
    if cache is not None:
        cache.save("disparity", ckey, {"disparity": disp})
    return disp


@_observed("reconstruct")
def reconstruct(disparity_map, Q) -> np.ndarray:
    """reconstruct_3D parity (cell 11): (H, W, 3) point image."""
    return np.asarray(
        G.reproject_image_to_3d(jnp.asarray(disparity_map, dtype=jnp.float32), jnp.asarray(Q, dtype=jnp.float32))
    )


@_observed("export_point_cloud")
def export_point_cloud(
    path: str, points_3d, disparity_map, colors=None
) -> int:
    """Validity-masked point-cloud export (cells 12-13): finite & disparity > 0.

    Format by extension: .html writes the standalone interactive WebGL
    viewer (the headless stand-in for the reference's Open3D window,
    main.ipynb cell 12 +38); anything else writes PLY."""
    pts = jnp.asarray(points_3d)
    d = jnp.asarray(disparity_map)
    mask = np.asarray(G.valid_point_mask(pts, d)).ravel()
    p = np.asarray(pts).reshape(-1, 3)[mask]
    c = None
    if colors is not None:
        c = np.asarray(colors).reshape(-1, 3)[mask]
    if path.endswith(".html"):
        from stereo_reconstruction_cv_tpu.io import viewer as VW

        return VW.write_html_viewer(path, p, c)
    return PLY.write_ply(path, p, c)


# ---------------------------------------------------------------------------
# Sparse reconstruction (triangulation path, [branch] capability)
# ---------------------------------------------------------------------------

@_observed("triangulate_sparse")
def triangulate_sparse(
    folder_or_pair,
    camera_matrix: Optional[np.ndarray] = None,
    baseline: float = 0.1,
    seed: int = 0,
    pipeline_cfg: cfg_mod.PipelineConfig = cfg_mod.DEFAULT,
) -> Dict:
    """Sparse 3D from matched inliers via batched DLT triangulation
    (README.md:29, 84-86): P1 = K[I|0], P2 = K[R|T*baseline]."""
    imL, imR = _load_pair(folder_or_pair)
    K = np.asarray(camera_matrix) if camera_matrix is not None else default_camera_matrix()
    geo = estimate_geometry((imL, imR), baseline, K, seed, pipeline_cfg)
    Kj = jnp.asarray(K)
    R = jnp.asarray(geo["Rotation Matrix"])
    T = jnp.asarray(geo["Translation Vector"]).reshape(3) * baseline
    P1 = Kj @ jnp.eye(3, 4, dtype=Kj.dtype)
    P2 = Kj @ jnp.concatenate([R, T[:, None]], axis=1)
    inl = jnp.asarray(geo["inlier_mask"])
    pts3d = G.triangulate_to_3d(P1, P2, jnp.asarray(geo["pts1"]), jnp.asarray(geo["pts2"]))
    depths = pts3d[:, 2]
    good = inl & (depths > 0) & jnp.all(jnp.isfinite(pts3d), axis=-1)
    return {
        "points": np.asarray(pts3d),
        "valid": np.asarray(good),
        "num_points": int(good.sum()),
        "geometry": geo,
    }
