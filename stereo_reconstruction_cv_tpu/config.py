"""Typed configuration tree with the reference project's exact defaults.

Every hard-coded constant of the reference is surfaced here as a dataclass
field so behavior parity is auditable. Citations point into the reference
(/root/reference) as ``gui.py:NN`` / ``main.ipynb cell C``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ChessboardConfig:
    """Calibration-target geometry (reference: gui.py:28, main.ipynb cell 1)."""

    # Inner-corner grid of the calibration chessboard (gui.py:28).
    cols: int = 9
    rows: int = 7
    # Termination criteria of the subpixel refinement (gui.py:29).
    subpix_max_iter: int = 30
    subpix_eps: float = 0.001
    # Half window of cornerSubPix (gui.py:57 uses an 11x11 window).
    subpix_win: int = 11
    # Dump corner-annotation images (gui.py:41 defaults False; notebook True).
    save_corner_annotations: bool = False


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Zhang calibration + LM refinement (reference: gui.py:64-73)."""

    chessboard: ChessboardConfig = dataclasses.field(default_factory=ChessboardConfig)
    # Number of distortion coefficients, OpenCV default 5: k1,k2,p1,p2,k3.
    num_dist_coeffs: int = 5
    # LM iterations (OpenCV calibrateCamera default TermCriteria 30, eps 2.22e-16).
    lm_max_iter: int = 30
    lm_eps: float = 2.220446049250313e-16


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Feature detection + matching (reference: gui.py:112-131, 211-241)."""

    # SIFT contrastThreshold default (gui.py:212; OpenCV default 0.04).
    contrast_threshold: float = 0.04
    # Lowe ratio: 0.7 in geometry/rectification paths (gui.py:129),
    # 0.75 in the standalone inspection tab (gui.py:241).
    ratio_geometry: float = 0.7
    ratio_inspect: float = 0.75
    # Maximum keypoints kept per image (static shape bound).
    max_keypoints: int = 4096
    # Descriptor length (XFeat-style learned descriptor; SIFT is 128).
    descriptor_dim: int = 64
    # Learned-path matcher gate: mutual NN + min cosine similarity
    # (upstream XFeat's policy; Lowe's ratio starves dense-grid learned
    # descriptors — ops.matching.match_learned).
    # Mutual-NN is already highly selective; a permissive absolute gate
    # keeps scenes whose correct matches peak at lower similarity (d2's
    # mutual matches top out near 0.8 yet are 85% F-inliers at 0.5 —
    # the r2 default of 0.82 starved it to 16 matches, XFEAT_EVAL r2).
    # The robust F-LMedS / E-RANSAC stages downstream absorb the extra
    # outliers by design.
    learned_min_cossim: float = 0.5
    # Guided LK subpixel refinement of learned matches (ops/refine.py):
    # aligns each right patch to its left patch at full resolution before
    # the robust stages, restoring the precision the fixed 1.0 px
    # E-RANSAC gate (gui.py:142) assumes of SIFT's DoG-interpolated
    # keypoints. Classical path never uses it.
    lk_refine: bool = True
    # Sweep (tools/xfeat_tune_d3.py): win 9 /
    # 16 iters closes the d3 rotation gap vs classical (R_angle 2.422 ->
    # 2.331 deg vs classical 2.387) with d1 unchanged — the wider patch +
    # deeper iteration stabilizes the LK alignment on d3's wide-baseline
    # 4K content. The cosine gate stays 0.5 (0.8 starves d3 to 265
    # E-inliers and flips the win).
    lk_win: int = 9
    lk_iters: int = 16


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Robust two-view estimation (reference: gui.py:135, 142)."""

    # F via LMedS (gui.py:135  cv2.FM_LMEDS).
    f_method: str = "lmeds"
    # E via RANSAC with prob=0.999, threshold=1.0 px (gui.py:142).
    e_prob: float = 0.999
    e_threshold_px: float = 1.0
    # Fixed hypothesis budget (batched, static shape). All
    # hypotheses solve/score simultaneously, so a large budget is cheap and
    # stabilizes the pose against small inlier sets.
    num_hypotheses: int = 1024
    # Points per minimal sample (normalized 8-point solver).
    sample_size: int = 8


@dataclasses.dataclass(frozen=True)
class RectifyConfig:
    """Stereo rectification (reference: gui.py:157, main.ipynb cell 7)."""

    # alpha=1.0 keeps all source pixels visible (gui.py:157).
    alpha: float = 1.0
    # Default fallback K when no calibration available (gui.py:93-94).
    default_fx: float = 1000.0
    default_fy: float = 1000.0
    default_cx: float = 960.0
    default_cy: float = 540.0


@dataclasses.dataclass(frozen=True)
class SGBMConfig:
    """Dense disparity, exact cv2.StereoSGBM parameter set (main.ipynb cell 10).

    blockSize=11, P1=8*3*11^2, P2=32*3*11^2, disp12MaxDiff=1, preFilterCap=63,
    uniquenessRatio=10, speckleWindowSize=100, speckleRange=32, /16 output.
    """

    min_disparity: int = 0
    num_disparities: int = 128
    block_size: int = 11
    p1: int = 8 * 3 * 11 * 11
    p2: int = 32 * 3 * 11 * 11
    disp12_max_diff: int = 1
    pre_filter_cap: int = 63
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    # 5 = cv2 default MODE_SGBM paths {L, R, UL, U, UR} (reference parity);
    # 8 = full SGM ("MODE_HH" analog, higher quality).
    num_directions: int = 5
    # DP scan chunking: blocks of `scan_chunk` scanned in parallel, warm-
    # started with `scan_halo` halo elements (an approximation). None =
    # exact sequential aggregation, the default.
    scan_chunk: int | None = None
    scan_halo: int = 32
    # Speckle backend: 'propagate' = device-side segmented min-scans
    # iterated to convergence (exact cv2.filterSpeckles parity on
    # convergence — real maps converge in 3-6 rounds; see speckle_filter);
    # 'exact' = host union-find via jax.pure_callback (unconditionally
    # exact, costs one device->host->device round-trip of the maps).
    speckle_backend: str = "propagate"

    def with_(self, **kw) -> "SGBMConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    calibration: CalibrationConfig = dataclasses.field(default_factory=CalibrationConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    robust: RobustConfig = dataclasses.field(default_factory=RobustConfig)
    rectify: RectifyConfig = dataclasses.field(default_factory=RectifyConfig)
    sgbm: SGBMConfig = dataclasses.field(default_factory=SGBMConfig)
    # Reference hardcodes (3840, 2160) (gui.py:109); we derive from the image.
    image_size: Tuple[int, int] | None = None


DEFAULT = PipelineConfig()
