"""Learned-vs-classical feature evaluation.

For each bundled pair (dataset/d1-d3) runs the full geometry pipeline with
(a) the classical multi-scale Harris/SIFT-like detector and (b) the
learned XFeat-style net (given checkpoint), and records: good-match count,
F-inlier count/ratio, E-inlier count, and the recovered pose. For d3 the
pose is scored against the reference notebook anchors
(/root/reference main.ipynb cell 6: R ~ I, T ~ [1, .0096, -.0039]).
Writes docs/XFEAT_EVAL.json.

Usage: python tools/xfeat_eval.py [checkpoint] [out.json]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

_K = np.array(
    [[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63], [0.0, 0.0, 1.0]]
)
_T_ANCHOR = np.array([1.0, 0.00964, -0.00387])


def _pose_metrics(out, with_anchor=False):
    R = np.asarray(out["Rotation Matrix"])
    T = np.asarray(out["Translation Vector"]).ravel()
    Tn = T / (np.linalg.norm(T) + 1e-30)
    ang = np.degrees(
        np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    )
    m = {
        "num_matches": out["num_matches"],
        "num_inliers_F": out["num_inliers_F"],
        "num_inliers_E": out["num_inliers_E"],
        "inlier_ratio_F": round(out["num_inliers_F"] / max(out["num_matches"], 1), 4),
        "R_angle_deg": round(float(ang), 4),
        "T_dir": [round(float(v), 5) for v in Tn],
    }
    if with_anchor:  # the notebook anchors exist only for d3
        terr = min(np.linalg.norm(Tn - _T_ANCHOR), np.linalg.norm(Tn + _T_ANCHOR))
        m["T_anchor_err"] = round(float(terr), 5)
    return m


def main(checkpoint=None, out_path="docs/XFEAT_EVAL.json"):
    import dataclasses
    import glob

    import jax

    from stereo_reconstruction_cv_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from stereo_reconstruction_cv_tpu import config as cfg_mod
    from stereo_reconstruction_cv_tpu.pipeline import stages

    # Optional matcher-gate override for tuning runs (STEREO_XF_COSSIM);
    # the committed artifact uses the library default.
    pcfg = cfg_mod.DEFAULT
    cs = os.environ.get("STEREO_XF_COSSIM")
    if cs:
        pcfg = dataclasses.replace(
            pcfg, match=dataclasses.replace(pcfg.match,
                                            learned_min_cossim=float(cs)))

    if checkpoint is None or not os.path.exists(checkpoint):
        # Same "latest shipped" rule as cli.py / benchmarks.py.
        cands = sorted(glob.glob("checkpoints/xfeat_v*.npz"))
        assert cands, "no shipped checkpoints"
        checkpoint = cands[-1]
    report = {"checkpoint": checkpoint, "pairs": {}}
    for d in ("d1", "d2", "d3"):
        folder = f"/root/reference/dataset/{d}"
        row = {}
        for method in ("classical", "learned"):
            try:
                out = stages.estimate_geometry(
                    folder, baseline=0.14, camera_matrix=_K,
                    method=method, pipeline_cfg=pcfg,
                    checkpoint=checkpoint if method == "learned" else None,
                )
                row[method] = _pose_metrics(out, with_anchor=(d == "d3"))
            except Exception as e:
                row[method] = {"error": f"{type(e).__name__}: {e}"[:200]}
        report["pairs"][d] = row
        print(d, json.dumps(row), flush=True)

    # Criterion: POSE ACCURACY ONLY — the raw
    # inlier-count arm is dropped (the learned path proposes ~15x the
    # matches, which made that arm nearly auto-won by volume). A pair is a
    # learned win iff R_angle <= classical's (these near-pure-translation
    # rigs have ground-truth R ~ identity, so smaller is better) AND,
    # where the notebook anchor exists (d3), T_anchor_err <= classical's.
    wins = 0
    for d, row in report["pairs"].items():
        c, l = row.get("classical", {}), row.get("learned", {})
        if "error" in c or "error" in l:
            continue
        ok = l["R_angle_deg"] <= c["R_angle_deg"]
        if "T_anchor_err" in l and "T_anchor_err" in c:
            ok = ok and l["T_anchor_err"] <= c["T_anchor_err"]
        if ok:
            wins += 1
    report["learned_wins"] = wins
    report["criterion"] = (
        "pose accuracy only: R_angle <= classical AND (where anchored) "
        "T_anchor_err <= classical"
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out_path}; learned wins on {wins}/3 pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
