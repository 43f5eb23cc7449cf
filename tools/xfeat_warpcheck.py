"""Quick learned-matcher quality gate: synthetic-warp true-match rate.

For each bundled left image, warps it with known random homographies,
runs the full detect+match path at the geometry stage's detection scale,
and reports the fraction of mutual matches within 3 px of the ground-
truth mapping. A healthy detector/descriptor pair scores >~60%; the r3
diagnosis started from v2 scoring 4-9% here (keypoint head trained with
a consistency-only loss — see models/xfeat.harris_cell_targets).

Usage: python tools/xfeat_warpcheck.py [checkpoint] [d1 d2 ...]
Runs on CPU by default so the accelerator stays free for training.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import numpy as np


def warp_true_rate(ckpt: str, dataset: str, seeds=(3, 4, 5), max_kpts=2048):
    import jax
    import jax.numpy as jnp

    from stereo_reconstruction_cv_tpu.models import xfeat as XF
    from stereo_reconstruction_cv_tpu.ops import matching as M
    from stereo_reconstruction_cv_tpu.pipeline import stages

    imL, _ = stages._load_pair(f"/root/reference/dataset/{dataset}")
    img = np.asarray(imL)
    factor = max(1, int(np.ceil(max(img.shape) / 2048)))
    if factor > 1:
        img = stages._downscale(img, factor)
    img = img.astype(np.float32)
    H, W = img.shape
    rates = []
    for seed in seeds:
        Hm = XF.random_homography(jax.random.PRNGKey(seed), H, W)
        warped = XF.warp_image(jnp.asarray(img), Hm)
        with jax.default_matmul_precision("highest"):
            fl = stages._learned_features(img.astype(np.uint8), max_kpts, ckpt)
            fr = stages._learned_features(
                np.asarray(warped).astype(np.uint8), max_kpts, ckpt)
            mres = M.match_learned(
                fl.descriptors.astype(jnp.float32),
                fr.descriptors.astype(jnp.float32),
                fl.mask, fr.mask, min_cossim=0.5)
        p1, p2, mask = M.gather_correspondences(fl.keypoints, fr.keypoints, mres)
        p1, p2, mask = np.asarray(p1), np.asarray(p2), np.asarray(mask)
        Hmn = np.asarray(Hm)
        ph = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ Hmn.T
        gt = ph[:, :2] / ph[:, 2:3]
        err = np.linalg.norm(gt - p2, axis=1)
        n = int(mask.sum())
        rates.append(((err[mask] < 3).mean() if n else 0.0, n))
    return rates


def main():
    args = sys.argv[1:]
    ckpt = args[0] if args else None
    if ckpt is None or not os.path.exists(ckpt):
        import glob

        ckpt = sorted(glob.glob("checkpoints/xfeat_v*.npz"))[-1]
    datasets = args[1:] or ["d1", "d2"]
    print(f"checkpoint: {ckpt}")
    for d in datasets:
        rates = warp_true_rate(ckpt, d)
        txt = " ".join(f"{r:.1%}(n={n})" for r, n in rates)
        print(f"{d}: {txt}", flush=True)


if __name__ == "__main__":
    main()
