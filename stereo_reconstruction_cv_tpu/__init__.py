"""stereo_reconstruction_cv_tpu — a stereo 3D-reconstruction framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the OpenCV reference
project ``rafayaamirgull/stereo_reconstruction_cv`` (see SURVEY.md):

- chessboard camera calibration (Zhang init + Levenberg-Marquardt refinement)
- two-view epipolar geometry (feature match + ratio test, robust F/E, pose)
- stereo rectification (Bouguet) with a fused undistort-rectify-remap kernel
- dense disparity via a semi-global block matching (SGBM) pipeline
- sparse reconstruction via batched triangulation
- learned (XFeat-style) feature detection/description/matching
- disparity -> 3D point-cloud reprojection and PLY export

Design is accelerator-first: batched/vmapped solvers, static shapes, `lax.scan`
recurrences, `shard_map` spatial sharding, a Pallas (Triton) kernel for the
SGM sweeps on the GPU.
"""

__version__ = "0.1.0"

from stereo_reconstruction_cv_tpu import config as config

__all__ = ["config", "__version__"]
