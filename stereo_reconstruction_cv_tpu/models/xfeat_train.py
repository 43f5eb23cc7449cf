"""XFeat training driver: real self-supervised training.

Replaces the toy loop (fixed top-left crops of <=16 images, 200 steps)
with: random crops sampled per step from every training image (the 44
calibration boards + the d1-d3 pairs by default), photometric jitter on
top of the loss's homographic warps, linear-warmup + cosine LR, and
periodic loss logging. The image pool is staged to device memory once
and every step samples, augments, and optimizes inside one jitted
program (zero per-step host transfer).

Reference surface this backs: XFeat learned matching, README.md:40-49,
109-110 (Tab 7 on the xfeat_integ branch).
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence

import numpy as np

from stereo_reconstruction_cv_tpu.io.image import load_gray

DEFAULT_FOLDERS = (
    "/root/reference/calibration_data_logitech_3840x2160",
    "/root/reference/dataset/d1",
    "/root/reference/dataset/d2",
    "/root/reference/dataset/d3",
)


def load_training_images(
    folders: Sequence[str], max_side: int = 1280, max_images: int = 64
) -> List[np.ndarray]:
    """Load every *.jpg, box-downscaled so max(H, W) <= max_side.

    Downscaling 4K sources keeps crop content diverse (a 256-px crop of a
    4K frame is mostly flat texture) and bounds host memory."""
    files: List[str] = []
    for d in folders:
        files += sorted(glob.glob(os.path.join(d, "*.jpg")))
    imgs = []
    for f in files[:max_images]:
        g = load_gray(f).astype(np.float32)
        H, W = g.shape
        k = int(np.ceil(max(H, W) / max_side))
        if k > 1:
            g = g[: H - H % k, : W - W % k]
            g = g.reshape(H // k, k, (W - W % k) // k, k).mean((1, 3))
        imgs.append(g)
    return imgs


def _device_batch(pool, key, batch: int, crop: int):
    """(batch, crop, crop) random crops + photometric jitter, all on
    device: one vmapped dynamic_slice per sample from the pre-staged image
    pool — zero host->device traffic per step."""
    import jax
    import jax.numpy as jnp

    N, Hs, Ws = pool.shape
    kn, ky, kx, kg, kb, ke = jax.random.split(key, 6)
    idx = jax.random.randint(kn, (batch,), 0, N)
    ys = jax.random.randint(ky, (batch,), 0, Hs - crop + 1)
    xs = jax.random.randint(kx, (batch,), 0, Ws - crop + 1)

    def one(i, y, x):
        return jax.lax.dynamic_slice(pool, (i, y, x), (1, crop, crop))[0]

    crops = jax.vmap(one)(idx, ys, xs)
    gain = jax.random.uniform(kg, (batch, 1, 1), minval=0.7, maxval=1.3)
    bias = jax.random.uniform(kb, (batch, 1, 1), minval=-20.0, maxval=20.0)
    noise = jax.random.normal(ke, crops.shape) * 3.0
    return jnp.clip(crops * gain + bias + noise, 0.0, 255.0)


def build_stereo_pool(datasets=("d1", "d2", "d3"), width: int = 1280,
                      ndisp: int = 64, cache_dir: str = "checkpoints"):
    """Rectified stereo quadruples for cross-view supervision: for each
    bundled pair, estimate geometry + rectify with the classical
    pipeline, box-downscale to <= `width`, and run the exact SGBM to get
    dense disparity labels. Returns stacked (P, Hs, Ws) arrays
    (left, right, disp, valid) cropped to a common size.

    The labels are the framework's own cv2-gated stereo output — the
    learned matcher is bootstrapped by classical geometry, not external
    data (see xfeat.xfeat_stereo_loss).

    Cached to {cache_dir}/stereo_pool_{width}_{ndisp}.npz: the build runs
    the full classical pipeline on three pairs and is deterministic."""
    import jax.numpy as jnp

    cache = os.path.join(cache_dir, f"stereo_pool_{width}_{ndisp}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return tuple(jnp.asarray(z[k]) for k in ("L", "R", "D", "V"))

    from stereo_reconstruction_cv_tpu.config import SGBMConfig
    from stereo_reconstruction_cv_tpu.ops import disparity as DP
    from stereo_reconstruction_cv_tpu.pipeline import stages

    K4 = np.array([[2253.71, 0.0, 1929.69], [0.0, 2244.72, 1057.63],
                   [0.0, 0.0, 1.0]])
    quads = []
    for d in datasets:
        folder = f"/root/reference/dataset/{d}"
        if not os.path.isdir(folder):
            continue
        res = stages.rectify_pair(folder, baseline=0.14, camera_matrix=K4,
                                  with_visualizations=False)
        rl = np.asarray(res["left_rectified"])
        rr = np.asarray(res["right_rectified"])
        if rl.ndim == 3:
            rl = rl.mean(-1)
            rr = rr.mean(-1)
        H, W = rl.shape
        k = int(np.ceil(W / width))
        if k > 1:
            rl = rl[: H - H % k, : W - W % k].reshape(H // k, k, -1, k).mean((1, 3))
            rr = rr[: H - H % k, : W - W % k].reshape(H // k, k, -1, k).mean((1, 3))
        cfg = SGBMConfig(num_disparities=ndisp, num_directions=5)
        dsp, val = DP.sgbm_disparity(
            jnp.asarray(np.clip(rl, 0, 255).astype(np.uint8)),
            jnp.asarray(np.clip(rr, 0, 255).astype(np.uint8)), cfg)
        quads.append((rl.astype(np.float32), rr.astype(np.float32),
                      np.asarray(dsp, np.float32),
                      np.asarray(val).astype(np.float32)))
    if not quads:
        return None
    Hs = min(q[0].shape[0] for q in quads)
    Ws = min(q[0].shape[1] for q in quads)
    stack_np = lambda i: np.stack([q[i][:Hs, :Ws] for q in quads])
    arrs = {k: stack_np(i) for i, k in enumerate(("L", "R", "D", "V"))}
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(cache, **arrs)
    return tuple(jnp.asarray(arrs[k]) for k in ("L", "R", "D", "V"))


def _stereo_batch(pool, key, batch: int, crop: int):
    """Aligned (left, right, disp, valid) crops + per-side photometric
    jitter. Crops share their row/column origin, so the disparity labels
    stay valid in crop-local coordinates."""
    import jax
    import jax.numpy as jnp

    L, R, D, V = pool
    N, Hs, Ws = L.shape
    kn, ky, kx, kg1, kb1, kg2, kb2, ke = jax.random.split(key, 8)
    idx = jax.random.randint(kn, (batch,), 0, N)
    ys = jax.random.randint(ky, (batch,), 0, Hs - crop + 1)
    xs = jax.random.randint(kx, (batch,), 0, Ws - crop + 1)

    def one(arr, i, y, x):
        return jax.lax.dynamic_slice(arr, (i, y, x), (1, crop, crop))[0]

    cl = jax.vmap(lambda i, y, x: one(L, i, y, x))(idx, ys, xs)
    cr = jax.vmap(lambda i, y, x: one(R, i, y, x))(idx, ys, xs)
    cd = jax.vmap(lambda i, y, x: one(D, i, y, x))(idx, ys, xs)
    cv = jax.vmap(lambda i, y, x: one(V, i, y, x))(idx, ys, xs)

    def jitter(c, kg, kb):
        gain = jax.random.uniform(kg, (batch, 1, 1), minval=0.7, maxval=1.3)
        bias = jax.random.uniform(kb, (batch, 1, 1), minval=-20.0, maxval=20.0)
        return jnp.clip(c * gain + bias, 0.0, 255.0)

    cl = jitter(cl, kg1, kb1) + jax.random.normal(ke, cl.shape) * 2.0
    cr = jitter(cr, kg2, kb2)
    return cl, cr, cd, cv > 0.5


def train(
    folders: Sequence[str] = DEFAULT_FOLDERS,
    steps: int = 5000,
    batch: int = 16,
    crop: int = 256,
    lr: float = 2e-3,
    warmup: int = 200,
    seed: int = 0,
    output: str = "checkpoints/xfeat_v5.npz",
    log_every: int = 100,
    max_images: int = 64,
    stereo: bool = False,
    init_from: str | None = None,
):
    """Train and save a checkpoint (.npz); returns the loss history.

    The image pool is staged to device memory once (cropped to a common
    size); every step samples, augments, and optimizes fully inside one
    jitted program. stereo=True adds cross-view supervision from the
    classical pipeline's own rectified pairs + SGBM disparity (the loss
    alternates homography and stereo terms); init_from warm-starts from
    an existing checkpoint."""
    import jax
    import jax.numpy as jnp
    import optax

    from stereo_reconstruction_cv_tpu.models import checkpoint as CK
    from stereo_reconstruction_cv_tpu.models import xfeat as XF

    from stereo_reconstruction_cv_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    imgs = load_training_images(folders, max_images=max_images)
    # Images smaller than the crop can neither be cropped nor reflect-padded
    # safely — skip them (the pre-round-2 CLI did the same), and never let a
    # small straggler collapse the pool size below the larger images.
    imgs = [g for g in imgs if g.shape[0] >= crop and g.shape[1] >= crop]
    if not imgs:
        raise FileNotFoundError(
            f"no *.jpg of at least {crop}x{crop} under {folders}"
        )
    # Common pool shape: crop every remaining image to the minimum H x W.
    Hs = min(g.shape[0] for g in imgs)
    Ws = min(g.shape[1] for g in imgs)
    pool = jnp.asarray(np.stack([g[:Hs, :Ws] for g in imgs]))

    model = XF.XFeatNet()
    key = jax.random.PRNGKey(seed)
    params = model.init(key, jnp.zeros((1, crop, crop, 1), jnp.float32))
    if init_from:
        params = CK.load_params(init_from, like=params)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
    # Global-norm clipping: the InfoNCE loss over 32x32 cells occasionally
    # spikes (observed NaN by step 100 unclipped at lr 2e-3).
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    state = XF.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))

    spool = build_stereo_pool() if stereo else None

    def step_fn(s, k):
        kd, kl, ks = jax.random.split(k, 3)
        data = _device_batch(pool, kd, batch, crop)

        def loss_fn(p):
            loss = XF.xfeat_loss(p, model, data, kl)
            if spool is not None:
                cl, cr, cd, cv = _stereo_batch(spool, ks, batch, crop)
                loss = 0.5 * loss + 0.5 * XF.xfeat_stereo_loss(
                    p, model, cl, cr, cd, cv)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(s.params)
        updates, opt_state = tx.update(grads, s.opt_state, s.params)
        new_params = optax.apply_updates(s.params, updates)
        return XF.TrainState(new_params, opt_state, s.step + 1), loss

    step_jit = jax.jit(step_fn)
    history = []
    for it in range(steps):
        key, sub = jax.random.split(key)
        state, loss = step_jit(state, sub)
        if it % log_every == 0 or it == steps - 1:
            lv = float(loss)
            history.append((it, lv))
            print(f"step {it}: loss {lv:.4f}", flush=True)
    CK.save_params(output, state.params)
    print(f"saved checkpoint to {output}")
    return history
