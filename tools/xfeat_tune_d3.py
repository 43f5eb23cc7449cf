"""Sweep the learned matcher's gate/refine knobs on the bundled pairs
(goal: close the 0.035deg d3 R_angle gap, no d1/d2
regression). One process so the XFeat forward and robust-solver programs
compile once. Usage: python tools/xfeat_tune_d3.py [combos]

combos: comma-separated cs:win:iters (default sweep).
"""

import dataclasses
import glob
import os
import sys

import numpy as np

sys.path.insert(0, "/root/repo")

import jax

from stereo_reconstruction_cv_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from stereo_reconstruction_cv_tpu import config as cfg_mod
from stereo_reconstruction_cv_tpu.pipeline import stages

_K = np.array(
    [[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]]
)
_T_ANCHOR = np.array([1.0, 0.00964, -0.00387])


def metrics(out):
    R = np.asarray(out["Rotation Matrix"])
    T = np.asarray(out["Translation Vector"]).ravel()
    Tn = T / (np.linalg.norm(T) + 1e-30)
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    terr = min(np.linalg.norm(Tn - _T_ANCHOR), np.linalg.norm(Tn + _T_ANCHOR))
    return float(ang), float(terr), int(out["num_inliers_E"])


def main():
    combos = [(0.5, 7, 8), (0.6, 7, 8), (0.7, 7, 8), (0.8, 7, 8),
              (0.5, 9, 16), (0.7, 9, 16)]
    if len(sys.argv) > 1:
        combos = [tuple(float(x) for x in c.split(":"))
                  for c in sys.argv[1].split(",")]
        combos = [(a, int(b), int(c)) for a, b, c in combos]
    ck = sorted(glob.glob("checkpoints/xfeat_v*.npz"))[-1]
    for d in ("d3", "d1", "d2"):
        folder = f"/root/reference/dataset/{d}"
        out = stages.estimate_geometry(folder, camera_matrix=_K, seed=0,
                                       method="classical")
        a, t, ne = metrics(out)
        print(f"{d} classical: R={a:.4f} Terr={t:.5f} nE={ne}", flush=True)
        for cs, win, iters in combos:
            pcfg = dataclasses.replace(
                cfg_mod.DEFAULT,
                match=dataclasses.replace(
                    cfg_mod.DEFAULT.match, learned_min_cossim=cs,
                    lk_win=win, lk_iters=iters,
                ),
            )
            out = stages.estimate_geometry(
                folder, camera_matrix=_K, seed=0, pipeline_cfg=pcfg,
                method="learned", checkpoint=ck,
            )
            a, t, ne = metrics(out)
            print(f"{d} learned cs={cs} win={win} it={iters}: "
                  f"R={a:.4f} Terr={t:.5f} nE={ne}", flush=True)


if __name__ == "__main__":
    main()
