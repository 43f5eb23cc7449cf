#!/usr/bin/env python3
"""Device smoke check: the stereo pipeline on an NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(e) on one card
    python chip_smoke.py --four-cards  # the row-sharded path on a 1x4 mesh

Phases, each on seeded scenes made in the repo (stereo_reconstruction_cv_tpu
.scenes), with random-free inputs except the seed:
  (a) device: JAX must find a GPU (never a CPU fallback); the card's name
      and power limit as nvidia-smi reports them.
  (b) dense end to end at the reference rig's full width: a 3840x2160 pair,
      rectify (alpha 0, identity-rotation rig, anchor K, 0.140 m baseline),
      SGBM with 256 disparities and 5 directions, speckle, reprojection to
      3D and PLY export; accuracy against the scene's ground truth.
  (c) cross-check at 1280x720, 128 disparities, 8 directions: the GPU
      pipeline against the same pipeline on this process's CPU backend.
  (d) the SGM sweep kernel against the XLA scans (`sgm_aggregate`) on the
      GPU at 4K x 256 x 5 and 720p x 128 x 8: bit-identical int32 volumes,
      and the time of both, alone and inside the whole `sgbm_disparity`.
  (e) sparse XFeat at 960x536 (shipped checkpoint, 1024 keypoints):
      detect_pair -> match_learned -> triangulate_points, GPU against CPU.
With --four-cards only the row-sharded SGBM (parallel/sgm_sharded.py) runs,
at 1920x1080, 128 disparities, 8 directions, against one card.

Every check raises on failure, so a failed phase ends the script with a
non-zero exit and no result line. Times are host-clock seconds around
`block_until_ready`, after a first (compiling) call. The last line of
standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0

# Phase (b) accuracy bounds, on pixels with known ground truth right of the
# cv2 minX1 margin. Set from a CPU run of the same pipeline on the same
# seeded scene at 1280x720 (96 disparities): 99.65% of the valid pixels
# within 1 px of the truth at 99.58% density. The bounds leave a margin
# for the 4K frame's own texture scale and, should it run in row tiles,
# the tiles' halo approximation.
DENSE_MIN_ACCURACY = 0.98   # valid pixels within 1 px of ground truth
DENSE_MIN_DENSITY = 0.95    # valid share of the known pixels

# Phase (c): rectified images may differ by one grey level where the f32
# banded-matmul remap rounds a .5 differently on the two backends (both run
# at Precision.HIGHEST). On identical rectified input the integer cost,
# aggregation, winner and validity are exact; only the f32 subpixel
# quotient may differ in its last bits between the backends' division
# code, far below cv2's 1/16 px output step.
RECT_MAX_LEVEL_DIFF = 1
RECT_MAX_DIFF_SHARE = 1e-3
SUBPIXEL_MAX_DIFF = 1e-4
PIPELINE_MIN_AGREEMENT = 0.99  # same validity and |d_gpu - d_cpu| <= 1/16 px

# Phase (e): f32 convolutions at matmul precision "highest" on both
# backends; sums are taken in another order, so outputs differ in the last
# bits. Those bits can reorder near-tied heatmap peaks in the top-k and
# tip mutual-nearest-neighbour ties at the cosine gate, so the keypoint and
# match sets are compared as sets.
XFEAT_MAX_DESC_DIFF = 1e-4
XFEAT_MIN_KEYPOINT_SHARE = 0.98
XFEAT_MIN_MATCH_SHARE = 0.95


class SmokeFailure(AssertionError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(count: int):
    """(a) Exit non-zero unless JAX's default backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX default backend {backend!r})")
    devs = jax.devices()
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        log(line)
    log(f"[a] jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return smi[0]


def warm_time(fn, *args, iters: int = 3):
    """(first call seconds incl. compile, median warm seconds, last output)."""
    from stereo_reconstruction_cv_tpu.utils.timing import warm_time as _warm

    return _warm(fn, args, iters)


def rig(width: int, height: int):
    """Anchor-K identity-rotation rig: (K, (R1, P1, R2, P2, Q)) as numpy
    float32 (jit closure constants, so the remap takes its affine path)."""
    import jax
    import jax.numpy as jnp

    from stereo_reconstruction_cv_tpu import scenes
    from stereo_reconstruction_cv_tpu.ops import rectify as RC

    K = scenes.anchor_k(width)
    with jax.default_device(jax.devices("cpu")[0]):
        res = RC.stereo_rectify(
            jnp.asarray(K), None, jnp.asarray(K), None, (width, height),
            jnp.eye(3), jnp.asarray([-scenes.ANCHOR_BASELINE_M, 0.0, 0.0]),
            alpha=0.0,
        )
        geo = tuple(np.asarray(a, np.float32)
                    for a in (res.R1, res.P1, res.R2, res.P2, res.Q))
    return K.astype(np.float32), geo


def dense_fns(K, geo, cfg):
    """Jitted stages of the dense path: rectify pair, speckle, reproject."""
    import jax
    import jax.numpy as jnp

    from stereo_reconstruction_cv_tpu.ops import disparity as DP
    from stereo_reconstruction_cv_tpu.ops import geometry as G
    from stereo_reconstruction_cv_tpu.ops import rectify as RC

    R1, P1, R2, P2, Q = geo

    @jax.jit
    def rectify(l, r):
        return (RC.rectify_remap(l, K, None, R1, P1).astype(jnp.uint8),
                RC.rectify_remap(r, K, None, R2, P2).astype(jnp.uint8))

    speckle = jax.jit(lambda d, v: DP._speckle(d, v, cfg))
    reproject = jax.jit(lambda d: G.reproject_image_to_3d(d, Q))
    return rectify, speckle, reproject


def dense_accuracy(scene, K, geo, disp, keep, num_disp):
    """(accuracy, density) against the rectified ground truth."""
    from stereo_reconstruction_cv_tpu import scenes

    R1, P1, R2, P2, _ = geo
    gt, known = scenes.rectified_ground_truth(scene, K, R1, P1, R2, P2)
    known[:, :num_disp] = False  # cv2's minX1 margin is invalid by design
    valid = keep & known
    acc = float((np.abs(disp - gt) <= 1.0)[valid].mean())
    density = float(valid.sum() / known.sum())
    return acc, density


def phase_dense(card: str, H=2160, W=3840, D=256, ndirs=5):
    """(b) rectify -> SGBM (auto whole/tiled) -> speckle -> 3D -> PLY."""
    import jax

    from stereo_reconstruction_cv_tpu import scenes
    from stereo_reconstruction_cv_tpu.config import SGBMConfig
    from stereo_reconstruction_cv_tpu.io import ply as PLY
    from stereo_reconstruction_cv_tpu.ops import disparity as DP

    t0 = time.perf_counter()
    scene = scenes.make_scene(H, W, D, seed=SEED)
    t_scene = time.perf_counter() - t0
    K, geo = rig(W, H)
    cfg = SGBMConfig(num_disparities=D, num_directions=ndirs)
    core = cfg.with_(speckle_window_size=0)
    rectify, speckle, reproject = dense_fns(K, geo, cfg)

    t0 = time.perf_counter()
    whole = DP.fits_whole_frame(H, W, core)
    t_plan = time.perf_counter() - t0
    bpc = DP.whole_frame_bytes_per_cell(H, W, core)
    cells = H * (W - D) * D
    log(f"[b] {W}x{H} x{D} x{ndirs}: {'whole frame' if whole else 'row tiles'}"
        f" ({bpc:.2f} B/cell planned, {bpc * cells / 1e9:.1f} GB; "
        f"plan compile {t_plan:.1f} s)")

    def frame(l, r):
        rl, rr = rectify(l, r)
        d, v = DP.sgbm_disparity_auto(rl, rr, core)
        keep = speckle(d, v)
        return d, keep, reproject(d)

    l = jax.device_put(scene.left)
    r = jax.device_put(scene.right)
    first, warm, (d, keep, pts) = warm_time(frame, l, r)
    # The process's peak so far is the frame's: phase (b) runs first, and
    # its SGBM is the largest program of the phase.
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0)
    log(f"[b] device memory peak {peak / 1e9:.2f} GB in use, "
        f"plan {bpc * cells / 1e9:.2f} GB")
    disp = np.asarray(d)
    keep = np.asarray(keep)
    pts = np.asarray(pts)
    check(disp.shape == (H, W) and np.isfinite(disp).all(), "disparity not finite")
    acc, density = dense_accuracy(scene, K, geo, disp, keep, D)
    check(acc >= DENSE_MIN_ACCURACY and density >= DENSE_MIN_DENSITY,
          f"dense accuracy {acc:.4f} / density {density:.4f} below "
          f"{DENSE_MIN_ACCURACY} / {DENSE_MIN_DENSITY}")
    cloud = pts[keep]
    check(np.isfinite(cloud).all() and len(cloud) > 0, "point cloud not finite")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.ply")
        t0 = time.perf_counter()
        n = PLY.write_ply(path, cloud)
        t_ply = time.perf_counter() - t0
        back, _ = PLY.read_ply(path)
    check(n == len(cloud) and np.array_equal(back, cloud.astype(np.float32)),
          "PLY round trip differs")
    log(f"[b] {card}: scene {t_scene:.2f} s (set-up); first frame {first:.2f} s; "
        f"warm frame {warm * 1e3:.1f} ms; PLY {n} points {t_ply * 1e3:.0f} ms; "
        f"accuracy {acc:.4f}, density {density:.4f}")
    return whole


def phase_cross_check(card: str, H=720, W=1280, D=128, ndirs=8):
    """(c) the same pipeline on the GPU and on the CPU backend."""
    import jax

    from stereo_reconstruction_cv_tpu import scenes
    from stereo_reconstruction_cv_tpu.config import SGBMConfig
    from stereo_reconstruction_cv_tpu.ops import disparity as DP

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    scene = scenes.make_scene(H, W, D, seed=SEED + 1)
    K, geo = rig(W, H)
    cfg = SGBMConfig(num_disparities=D, num_directions=ndirs)
    rectify, _, _ = dense_fns(K, geo, cfg)

    def pipeline(dev):
        l = jax.device_put(scene.left, dev)
        r = jax.device_put(scene.right, dev)
        rl, rr = rectify(l, r)
        d, v = DP.sgbm_disparity(rl, rr, cfg)
        return [np.asarray(a) for a in (rl, rr, d, v)]

    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        rl_g, rr_g, d_g, v_g = pipeline(gpu)
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        rl_c, rr_c, d_c, v_c = pipeline(cpu)
        t_cpu = time.perf_counter() - t0
        # The SGBM alone on identical (CPU-rectified) input: exact.
        d_x, v_x = DP.sgbm_disparity(jax.device_put(rl_c, gpu),
                                     jax.device_put(rr_c, gpu), cfg)
    d_x, v_x = np.asarray(d_x), np.asarray(v_x)
    rect_diff = max(np.abs(rl_g.astype(int) - rl_c).max(),
                    np.abs(rr_g.astype(int) - rr_c).max())
    rect_share = max((rl_g != rl_c).mean(), (rr_g != rr_c).mean())
    check(rect_diff <= RECT_MAX_LEVEL_DIFF and rect_share <= RECT_MAX_DIFF_SHARE,
          f"rectified images differ by {rect_diff} levels on {rect_share:.2e}")
    sub_diff = float(np.abs(d_x - d_c).max())
    check(np.array_equal(v_x, v_c) and sub_diff <= SUBPIXEL_MAX_DIFF,
          f"SGBM on identical input differs: {(v_x != v_c).sum()} validity "
          f"pixels, disparity by up to {sub_diff:.2e}")
    same = (v_g == v_c) & (~v_c | (np.abs(d_g - d_c) <= 1.0 / 16))
    agree = float(same.mean())
    check(agree >= PIPELINE_MIN_AGREEMENT, f"GPU vs CPU pipeline agreement {agree:.4f}")
    log(f"[c] {card}: {W}x{H} x{D} x{ndirs} GPU {t_gpu:.2f} s, CPU {t_cpu:.2f} s "
        f"(first calls); rectified max diff {rect_diff} level on "
        f"{rect_share:.2e} of pixels; SGBM on identical input: validity "
        f"identical, disparity max diff {sub_diff:.1e} on "
        f"{(d_x != d_c).mean():.2e} of pixels; "
        f"pipeline agreement {agree:.5f}")


def phase_kernel(card: str, shapes=((2160, 3840, 256, 5), (720, 1280, 128, 8))):
    """(d) Triton sweeps vs XLA scans, alone and inside sgbm_disparity."""
    import jax
    import jax.numpy as jnp

    from stereo_reconstruction_cv_tpu import scenes
    from stereo_reconstruction_cv_tpu.config import SGBMConfig
    from stereo_reconstruction_cv_tpu.ops import disparity as DP

    results = []
    for H, W, D, nd in shapes:
        scene = scenes.make_scene(H, W, D, seed=SEED + 3)
        cfg = SGBMConfig(num_disparities=D, num_directions=nd)
        dirs = DP.DIRS_8 if nd == 8 else DP.DIRS_5
        l = jax.device_put(scene.left)
        r = jax.device_put(scene.right)
        C = jax.jit(lambda a, b: DP.sgbm_cost_volume(a, b, cfg))(l, r)

        def xla_agg(c, cfg_):
            return DP.sgm_aggregate(c, cfg_.p1, cfg_.p2, dirs, chunk=None)

        kern = jax.jit(lambda c: DP.sgm_aggregate_auto(c, cfg))
        ref = jax.jit(lambda c: xla_agg(c, cfg))
        # The XLA scans first: their temporaries need most of the card.
        _, t_x, S_x = warm_time(ref, C)
        _, t_k, S_k = warm_time(kern, C)
        same = bool(jnp.array_equal(S_k, S_x))
        del S_k, S_x, C  # the whole-call runs below need the memory
        check(same, f"sweep kernel != sgm_aggregate at {W}x{H} x{D} x{nd}")
        full_k = jax.jit(lambda a, b: DP.sgbm_disparity_with(a, b, cfg, DP.sgm_aggregate_auto))
        full_x = jax.jit(lambda a, b: DP.sgbm_disparity_with(a, b, cfg, xla_agg))
        _, tf_k, _ = warm_time(full_k, l, r)
        _, tf_x, _ = warm_time(full_x, l, r)
        log(f"[d] {card}: {W}x{H} x{D} x{nd} aggregation bit-identical; "
            f"sweep kernel {t_k * 1e3:.1f} ms vs XLA scans {t_x * 1e3:.1f} ms; "
            f"whole sgbm_disparity {tf_k * 1e3:.1f} ms vs {tf_x * 1e3:.1f} ms")
        results.append((t_k, t_x, tf_k, tf_x))
    return results


def phase_sparse(card: str, H=536, W=960, maxk=1024):
    """(e) XFeat detect -> match -> triangulate, GPU against CPU."""
    import jax
    import jax.numpy as jnp

    from stereo_reconstruction_cv_tpu import scenes
    from stereo_reconstruction_cv_tpu.models import checkpoint as CK
    from stereo_reconstruction_cv_tpu.models import xfeat as XF
    from stereo_reconstruction_cv_tpu.ops import geometry as G
    from stereo_reconstruction_cv_tpu.ops import matching as MT

    here = os.path.dirname(os.path.abspath(__file__))
    model = XF.XFeatNet()
    params = CK.load_params(os.path.join(here, "checkpoints", "xfeat_v4.npz"))
    scene = scenes.make_scene(H, W, 64, seed=SEED + 2)
    _, (_, P1, _, P2, _) = rig(W, H)

    def sparse(p, l, r):
        f1, f2 = XF.detect_pair(p, model, l, r, maxk)
        res = MT.match_learned(f1.descriptors, f2.descriptors, f1.mask, f2.mask)
        p1, p2, w = MT.gather_correspondences(f1.keypoints, f2.keypoints, res)
        pts = G.triangulate_points(jnp.asarray(P1), jnp.asarray(P2), p1, p2)
        x = jnp.stack([l, r]).astype(jnp.float32)[..., None] / 255.0
        _, desc, _ = model.apply(p, x)
        return f1.keypoints, f1.mask, p1, p2, w, pts, desc

    step = jax.jit(sparse)

    def run(dev):
        args = jax.device_put((params, scene.left, scene.right), dev)
        return warm_time(step, *args)

    with jax.default_matmul_precision("highest"):
        first, warm, out_g = run(jax.devices()[0])
        _, _, out_c = run(jax.devices("cpu")[0])
    kp_g, m_g, p1_g, p2_g, w_g, pts_g, desc_g = (np.asarray(a) for a in out_g)
    kp_c, m_c, p1_c, p2_c, w_c, _, desc_c = (np.asarray(a) for a in out_c)
    desc_diff = float(np.abs(desc_g - desc_c).max())
    check(desc_diff <= XFEAT_MAX_DESC_DIFF, f"descriptor field differs by {desc_diff:.2e}")
    kg = kp_g[m_g]
    kc = kp_c[m_c]
    near = np.abs(kg[:, None, :] - kc[None, :, :]).max(-1).min(1) <= 0.05
    kp_share = float(near.mean())
    check(kp_share >= XFEAT_MIN_KEYPOINT_SHARE, f"keypoint share {kp_share:.4f}")

    def match_set(p1, p2, w):
        return {tuple(np.round(np.r_[a, b], 1)) for a, b in zip(p1[w], p2[w])}

    mg, mc = match_set(p1_g, p2_g, w_g), match_set(p1_c, p2_c, w_c)
    match_share = len(mg & mc) / max(len(mg | mc), 1)
    check(len(mg) > 100 and match_share >= XFEAT_MIN_MATCH_SHARE,
          f"{len(mg)} GPU matches, {match_share:.4f} shared with the CPU")
    check(np.isfinite(pts_g[w_g]).all(), "triangulated points not finite")
    log(f"[e] {card}: {W}x{H} maxk {maxk}: first {first:.2f} s, warm "
        f"{warm * 1e3:.2f} ms/pair; {len(mg)} matches, {match_share:.4f} shared "
        f"with CPU; keypoints {kp_share:.4f}; descriptor max diff {desc_diff:.1e}")


def phase_four_cards(card: str, H=1080, W=1920, D=128, ndirs=8, n_space=4):
    """Row-sharded SGBM on a 1 x n_space mesh against one card."""
    import jax
    import jax.numpy as jnp

    from stereo_reconstruction_cv_tpu import scenes
    from stereo_reconstruction_cv_tpu.config import SGBMConfig
    from stereo_reconstruction_cv_tpu.ops import disparity as DP
    from stereo_reconstruction_cv_tpu.parallel import mesh as M
    from stereo_reconstruction_cv_tpu.parallel.sgm_sharded import sharded_sgbm_disparity

    scene = scenes.make_scene(H, W, D, seed=SEED + 4)
    cfg = SGBMConfig(num_disparities=D, num_directions=ndirs)
    mesh = M.make_mesh(n_data=1, n_space=n_space)
    one = jax.devices()[0]
    _, t_one, (d1, v1) = warm_time(
        DP.sgbm_disparity, jax.device_put(scene.left, one),
        jax.device_put(scene.right, one), cfg)
    d1, v1 = np.asarray(d1), np.asarray(v1)
    shard = M.batch_row_sharding(mesh)
    L = jax.device_put(jnp.asarray(scene.left[None]), shard)
    R = jax.device_put(jnp.asarray(scene.right[None]), shard)
    exact = jax.jit(lambda a, b: sharded_sgbm_disparity(mesh, a, b, cfg, exact=True))
    halo = jax.jit(lambda a, b: sharded_sgbm_disparity(mesh, a, b, cfg, halo=32))
    _, t_x, (dx, vx) = warm_time(exact, L, R)
    _, t_h, (dh, vh) = warm_time(halo, L, R)
    dx, vx, dh, vh = (np.asarray(a)[0] for a in (dx, vx, dh, vh))
    check(np.array_equal(vx, v1) and np.array_equal(dx, d1),
          f"exact sharded != one card: {(vx != v1).sum()} validity, "
          f"{(dx != d1).sum()} disparity pixels")
    both = vh & v1
    agree = float((np.abs(dh - d1) <= 1.0)[both].mean())
    check(agree >= 0.99, f"halo mode agreement {agree:.4f} < 0.99")
    log(f"[4] {card}: {W}x{H} x{D} x{ndirs} on 1x{n_space}: exact mode "
        f"bit-identical to one card; halo mode {agree:.5f} within 1 px on "
        f"both-valid; one card {t_one * 1e3:.1f} ms, exact {t_x * 1e3:.1f} ms, "
        f"halo {t_h * 1e3:.1f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded path on four GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    card = device_phase(count)

    import jax

    from stereo_reconstruction_cv_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_dense(card)
        phase_cross_check(card)
        phase_kernel(card)
        phase_sparse(card)
    log(f"smoke passed in {time.perf_counter() - t0:.1f} s")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
