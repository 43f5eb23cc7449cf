"""XFeat-style learned feature detector/descriptor in plain JAX.

The reference endorses XFeat learned matching as its accelerated feature
path (README.md:24, 40-49 [branch xfeat_integ]; torch dependency in
environment.yml:100). This is a ground-up JAX implementation of the same
*idea* — a small convnet emitting a keypoint heatmap, dense 64-d
descriptors and a reliability map: channels-last NHWC convolutions
(`lax.conv_general_dilated`), static shapes, and detection as a top-k
over the heatmap (no data-dependent shapes).

Architecture (XFeat-flavored, not a weight-compatible port):
  keypoint branch: 8x8 space-to-depth of the grayscale image -> 1x1 conv
    stack -> (H/8, W/8, 65) logits (64 cell positions + dustbin).
  descriptor branch: strided conv pyramid 1 -> 24 -> 64 at 1/8 resolution
    with a skip fusion, emitting 64-d descriptors + reliability.

Parameters are a nested dict {"params": {layer: {...}}} whose layer names
(Conv_k, ConvBlock_k/{Conv_0, LayerNorm_0}) are those of the shipped
checkpoints (models/checkpoint.py).

Training: self-supervised homographic-pair distillation — warp an image
with a random homography, require (i) descriptor InfoNCE between
corresponding cells and (ii) keypoint-heatmap consistency under the warp.
One jitted train step, data-parallel over a device mesh ('data' axis).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax


CELL = 8  # keypoint cell size (1/8 resolution), as in SuperPoint/XFeat
_LN_EPS = 1e-6
# Descriptor pyramid: (output channels, stride) of each ConvBlock.
_BLOCKS = ((8, 1), (24, 2), (24, 1), (48, 2), (48, 1), (96, 2), (96, 1), (96, 1))


def _conv(x, kernel, stride: int = 1, bias=None):
    """NHWC x HWIO convolution, SAME padding."""
    y = jax.lax.conv_general_dilated(
        x, kernel, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y if bias is None else y + bias


def _layer_norm(x, scale, bias):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + _LN_EPS) * scale + bias


def max_pool_same(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """k x k max pool, stride 1, SAME padding, over the last two axes."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1,) * (x.ndim - 2) + (k, k),
        (1,) * x.ndim, "SAME",
    )


@dataclasses.dataclass(frozen=True)
class XFeatNet:
    """Grayscale (B, H, W, 1) in [0, 1] -> (heatmap logits, descriptors,
    reliability). H, W must be multiples of 8."""

    desc_dim: int = 64

    def init(self, key, x: jnp.ndarray) -> dict:
        """Fresh parameters (LeCun-normal kernels, zero biases); `x` only
        fixes the input channel count."""
        cin = x.shape[-1]
        keys = iter(jax.random.split(key, 16))
        kinit = jax.nn.initializers.lecun_normal()

        def conv(k, ci, co, bias=True):
            p = {"kernel": kinit(next(keys), (k, k, ci, co), jnp.float32)}
            if bias:
                p["bias"] = jnp.zeros((co,), jnp.float32)
            return p

        p = {
            "Conv_0": conv(1, CELL * CELL * cin, 64),
            "Conv_1": conv(1, 64, 64),
            "Conv_2": conv(1, 64, CELL * CELL + 1),
        }
        ci = cin
        for i, (co, _) in enumerate(_BLOCKS):
            p[f"ConvBlock_{i}"] = {
                "Conv_0": conv(3, ci, co, bias=False),
                "LayerNorm_0": {"scale": jnp.ones((co,), jnp.float32),
                                "bias": jnp.zeros((co,), jnp.float32)},
            }
            ci = co
        p["Conv_3"] = conv(1, _BLOCKS[3][0], _BLOCKS[-1][0])
        p["Conv_4"] = conv(1, _BLOCKS[-1][0], self.desc_dim)
        p["Conv_5"] = conv(1, _BLOCKS[-1][0], 1)
        return {"params": p}

    def apply(self, params: dict, x: jnp.ndarray):
        p = params["params"]
        B, H, W, _ = x.shape
        # --- keypoint branch: space-to-depth + 1x1 convs (cheap, full-res info)
        s2d = x.reshape(B, H // CELL, CELL, W // CELL, CELL, 1)
        s2d = s2d.transpose(0, 1, 3, 2, 4, 5).reshape(B, H // CELL, W // CELL, CELL * CELL)
        k = jax.nn.relu(_conv(s2d, **p["Conv_0"]))
        k = jax.nn.relu(_conv(k, **p["Conv_1"]))
        kpt_logits = _conv(k, **p["Conv_2"])  # (B, H/8, W/8, 65)

        # --- descriptor branch: strided pyramid to 1/8
        feats = []
        h = x
        for i, (_, stride) in enumerate(_BLOCKS):
            blk = p[f"ConvBlock_{i}"]
            h = _conv(h, blk["Conv_0"]["kernel"], stride)
            h = jax.nn.relu(_layer_norm(h, **blk["LayerNorm_0"]))
            feats.append(h)
        d2, d4 = feats[3], feats[7]  # H/4 (48 ch) and H/8 (96 ch)
        up = jax.image.resize(d2, d4.shape[:3] + (d2.shape[-1],), "bilinear")
        fused = d4 + _conv(up, **p["Conv_3"])
        desc = _conv(fused, **p["Conv_4"])  # (B, H/8, W/8, 64)
        # rsqrt(sum^2 + eps), NOT norm + eps: the norm's backward at an
        # exactly-zero vector is 0/0 = NaN, and warped training crops
        # produce constant-zero border cells whose descriptors are exactly
        # zero at init (observed: NaN gradients on step 0).
        desc = desc * jax.lax.rsqrt(
            jnp.sum(desc * desc, axis=-1, keepdims=True) + 1e-12
        )
        reliability = jax.nn.sigmoid(_conv(fused, **p["Conv_5"])[..., 0])
        return kpt_logits, desc, reliability


class Features(NamedTuple):
    keypoints: jnp.ndarray   # (N, 2) xy, full-res pixels
    scores: jnp.ndarray      # (N,)
    descriptors: jnp.ndarray  # (N, D) L2-normalized
    mask: jnp.ndarray        # (N,) valid


def heatmap_from_logits(kpt_logits: jnp.ndarray) -> jnp.ndarray:
    """(B, Hc, Wc, 65) -> (B, H, W) full-res keypoint probability."""
    prob = jax.nn.softmax(kpt_logits, axis=-1)[..., :-1]  # drop dustbin
    B, Hc, Wc, _ = prob.shape
    prob = prob.reshape(B, Hc, Wc, CELL, CELL)
    prob = prob.transpose(0, 1, 3, 2, 4).reshape(B, Hc * CELL, Wc * CELL)
    return prob


def detect(
    params,
    model: XFeatNet,
    img: jnp.ndarray,
    max_keypoints: int = 1024,
    nms_radius: int = 4,
    image_refine: bool = True,
) -> Features:
    """Static-shape detection: top-k NMS peaks of the heatmap, descriptors
    bilinearly sampled from the 1/8 grid. img: (H, W) uint8/float."""
    x = (img.astype(jnp.float32) / 255.0)[None, ..., None]
    kpt_logits, desc, reliability = model.apply(params, x)
    heat = heatmap_from_logits(kpt_logits)[0]
    return _detect_post(
        img, heat, desc[0], reliability[0], max_keypoints, nms_radius,
        image_refine,
    )


def detect_pair(
    params,
    model: XFeatNet,
    img_left: jnp.ndarray,
    img_right: jnp.ndarray,
    max_keypoints: int = 1024,
    nms_radius: int = 4,
    image_refine: bool = True,
) -> Tuple[Features, Features]:
    """Detect on a stereo pair with ONE batched network forward (B=2):
    per-image B=1 forwards pay every launch twice at the small channel
    counts of this net. Identical outputs to two `detect` calls."""
    x = jnp.stack([img_left, img_right]).astype(jnp.float32) / 255.0
    kpt_logits, desc, reliability = model.apply(params, x[..., None])
    heats = heatmap_from_logits(kpt_logits)
    fl = _detect_post(img_left, heats[0], desc[0], reliability[0],
                      max_keypoints, nms_radius, image_refine)
    fr = _detect_post(img_right, heats[1], desc[1], reliability[1],
                      max_keypoints, nms_radius, image_refine)
    return fl, fr


def _detect_post(
    img: jnp.ndarray,
    heat: jnp.ndarray,
    desc: jnp.ndarray,
    reliability: jnp.ndarray,
    max_keypoints: int,
    nms_radius: int,
    image_refine: bool,
) -> Features:
    H, W = heat.shape
    # NMS via max-pool equality.
    k = 2 * nms_radius + 1
    pooled = max_pool_same(heat, k)
    is_peak = (heat == pooled) & (heat > 0)
    scores = jnp.where(is_peak, heat, 0.0)
    # Tiled top-k: NMS peaks are > nms_radius apart (Chebyshev), so a
    # t x t tile with t <= nms_radius holds at most one peak (up to exact
    # float ties, which the tile argmax then breaks first-index like
    # top_k would among equals) — reduce each 4x4 tile to its max before
    # the top_k, shrinking its input 16x.
    t = min(4, max(1, nms_radius))
    # Fall back to the flat path when the tile count can't supply k peaks
    # (top_k requires k <= n) — small crops with large max_keypoints.
    if H % t == 0 and W % t == 0 and (H // t) * (W // t) >= max_keypoints:
        tiles = scores.reshape(H // t, t, W // t, t).transpose(0, 2, 1, 3)
        tiles = tiles.reshape(H // t, W // t, t * t)
        tmax = jnp.max(tiles, axis=-1)
        targ = jnp.argmax(tiles, axis=-1).astype(jnp.int32)
        top, tidx = jax.lax.top_k(tmax.ravel(), max_keypoints)
        sub = targ.ravel()[tidx]
        yi = (tidx // (W // t)).astype(jnp.int32) * t + sub // t
        xi = (tidx % (W // t)).astype(jnp.int32) * t + sub % t
    else:
        top, idx = jax.lax.top_k(scores.ravel(), max_keypoints)
        yi = (idx // W).astype(jnp.int32)
        xi = (idx % W).astype(jnp.int32)
    # Quadratic subpixel refine on the heatmap: integer-snapped keypoints
    # cost ~0.5 px of epipolar residual (x2 at the geometry path's
    # detection downscale), which starves E-inlier counts on 4K pairs.
    def frac(center, lo, hi):
        denom = lo + hi - 2.0 * center
        off = 0.5 * (lo - hi) / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
        return jnp.clip(off, -0.5, 0.5)

    xc = jnp.clip(xi, 1, W - 2)
    yc = jnp.clip(yi, 1, H - 2)
    ox = frac(heat[yc, xc], heat[yc, xc - 1], heat[yc, xc + 1])
    oy = frac(heat[yc, xc], heat[yc - 1, xc], heat[yc + 1, xc])
    xs = xi.astype(jnp.float32) + jnp.where(xi == xc, ox, 0.0)
    ys = yi.astype(jnp.float32) + jnp.where(yi == yc, oy, 0.0)
    kpts = jnp.stack([xs, ys], axis=-1)
    if image_refine:
        # Image-gradient subpixel refinement (the calib stack's batched
        # cv2.cornerSubPix, calib/chessboard.py): the net's heatmap is
        # trained on 8-px cells and localizes peaks to ~1-2 px, which
        # starves E-inlier counts against the reference's fixed 1-px
        # RANSAC threshold (gui.py:142; r3 XFEAT_EVAL d2: 35/1314 E
        # inliers). Corner keypoints (the harris_cell_targets teacher)
        # refine to ~0.1 px on the intensity saddle; keypoints where the
        # refinement diverges past 1.5 px (edges, blobs) keep the heatmap
        # estimate.
        # Patch-resident variant: one patch fetch per keypoint, then
        # batched-matmul resampling (no per-iteration gathers).
        from stereo_reconstruction_cv_tpu.calib.chessboard import (
            corner_subpix_patch,
        )

        refined = corner_subpix_patch(img, kpts, win=3, max_iter=5,
                                      max_drift=5.0)
        keep = jnp.max(jnp.abs(refined - kpts), axis=-1) <= 1.5
        kpts = jnp.where(keep[:, None], refined, kpts)
        xs = kpts[:, 0]
        ys = kpts[:, 1]
    # Bilinear descriptor sampling on the 1/8 grid.
    gx = xs / CELL - 0.5
    gy = ys / CELL - 0.5
    Hc, Wc = desc.shape[:2]
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, Wc - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, Hc - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)[:, None]
    fy = jnp.clip(gy - y0, 0.0, 1.0)[:, None]
    d = desc
    v = (
        d[y0, x0] * (1 - fx) * (1 - fy)
        + d[y0, x0 + 1] * fx * (1 - fy)
        + d[y0 + 1, x0] * (1 - fx) * fy
        + d[y0 + 1, x0 + 1] * fx * fy
    )
    v = v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-8)
    rel = reliability[jnp.clip(ys.astype(jnp.int32) // CELL, 0, Hc - 1),
                      jnp.clip(xs.astype(jnp.int32) // CELL, 0, Wc - 1)]
    return Features(kpts, top * rel, v, top > 0)


# ---------------------------------------------------------------------------
# Self-supervised training (homographic pairs)
# ---------------------------------------------------------------------------

def random_homography(
    key, H: int, W: int, max_shift: float = 0.15,
    max_rot: float = 0.35, scale_range: float = 0.25,
):
    """Random perspective warp mapping image A coords -> image B coords.

    Composes rotation (+- max_rot rad), isotropic scale (1 +- scale_range)
    and per-corner perspective jitter — viewpoint changes between real
    stereo frames include all three; homography-only training left the
    descriptors rotation/scale-brittle (round-2 XFEAT_EVAL: d2/d3 pose
    failures)."""
    k1, k2, k3 = jax.random.split(key, 3)
    # Explicit f32: under jax_enable_x64 the defaults promote to f64.
    corners = jnp.array([[0.0, 0.0], [W, 0.0], [0.0, H], [W, H]], jnp.float32)
    shift = jax.random.uniform(
        k1, (4, 2), minval=-max_shift, maxval=max_shift, dtype=jnp.float32
    )
    target = corners + shift * jnp.array([W, H], jnp.float32)
    # Rotate + scale the target quad about the image center.
    ang = jax.random.uniform(k2, (), minval=-max_rot, maxval=max_rot,
                             dtype=jnp.float32)
    sc = jax.random.uniform(k3, (), minval=1.0 - scale_range,
                            maxval=1.0 + scale_range, dtype=jnp.float32)
    ca, sa = jnp.cos(ang) * sc, jnp.sin(ang) * sc
    ctr = jnp.array([W / 2.0, H / 2.0], jnp.float32)
    rel = target - ctr
    target = ctr + jnp.stack(
        [ca * rel[:, 0] - sa * rel[:, 1], sa * rel[:, 0] + ca * rel[:, 1]], -1
    )

    # 4-point homography with h33 = 1: an 8x8 linear solve.
    def row(c, t):
        x, y = c
        u, v = t
        return (
            jnp.array([x, y, 1, 0, 0, 0, -u * x, -u * y], jnp.float32),
            jnp.array([0, 0, 0, x, y, 1, -v * x, -v * y], jnp.float32),
        )

    rows = []
    rhs = []
    for i in range(4):
        r1, r2 = row(corners[i], target[i])
        rows += [r1, r2]
        rhs += [target[i, 0], target[i, 1]]
    A = jnp.stack(rows)
    b = jnp.stack(rhs)
    h = jnp.linalg.solve(A, b)
    return jnp.concatenate([h, jnp.ones(1, jnp.float32)]).reshape(3, 3)


def warp_image(img: jnp.ndarray, Hm: jnp.ndarray) -> jnp.ndarray:
    """Inverse-warp (H, W) image by homography (bilinear, zero border)."""
    H, W = img.shape
    Hinv = jnp.linalg.inv(Hm.astype(jnp.float32))
    yy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    den = Hinv[2, 0] * xx + Hinv[2, 1] * yy + Hinv[2, 2]
    sx = (Hinv[0, 0] * xx + Hinv[0, 1] * yy + Hinv[0, 2]) / den
    sy = (Hinv[1, 0] * xx + Hinv[1, 1] * yy + Hinv[1, 2]) / den
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = sx - x0
    fy = sy - y0

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return jnp.where(inb, img[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)], 0)

    return (
        tap(x0, y0) * (1 - fx) * (1 - fy)
        + tap(x0 + 1, y0) * fx * (1 - fy)
        + tap(x0, y0 + 1) * (1 - fx) * fy
        + tap(x0 + 1, y0 + 1) * fx * fy
    )


def _cell_centers(Hc: int, Wc: int) -> jnp.ndarray:
    ys = (jnp.arange(Hc, dtype=jnp.float32) + 0.5) * CELL
    xs = (jnp.arange(Wc, dtype=jnp.float32) + 0.5) * CELL
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
    return jnp.stack([gx, gy], axis=-1)  # (Hc, Wc, 2)


def _cells_loss(da_i, db_i, la_i, lb_i, ra_i, pb, valid_in,
                bank=None, bank_offset=0):
    """Cell-correspondence loss for one A/B pair given, for every A cell
    center, its position `pb` (Hc, Wc, 2) in image B and a validity mask.
    Shared by the homography-warp and the stereo-disparity supervision
    paths (InfoNCE descriptors + keypoint-heatmap consistency +
    reliability-tracks-correctness).

    bank: optional (M, D) descriptor bank replacing db_i as the InfoNCE
    negative pool (db_i's cells sit at rows bank_offset..bank_offset+N).
    A full-image match at 1080p ranks ~15k cells; training against only
    the 1024 cells of a 256-crop left v2's descriptors unable to
    separate that many distractors (4-9%% keypoint-match true rate on
    synthetic warps) — cross-batch banks restore inference-difficulty
    negatives."""
    Hc, Wc = da_i.shape[:2]
    cb = jnp.round(pb / CELL - 0.5).astype(jnp.int32)
    valid = (
        valid_in
        & (cb[..., 0] >= 0) & (cb[..., 0] < Wc)
        & (cb[..., 1] >= 0) & (cb[..., 1] < Hc)
    )
    cbx = jnp.clip(cb[..., 0], 0, Wc - 1)
    cby = jnp.clip(cb[..., 1], 0, Hc - 1)
    # InfoNCE: A cell descriptor should match its B counterpart.
    a = da_i.reshape(-1, da_i.shape[-1])  # (N, D)
    pos = db_i[cby, cbx].reshape(-1, da_i.shape[-1])
    neg = db_i.reshape(-1, da_i.shape[-1]) if bank is None else bank
    logits = a @ neg.T / 0.1  # (N, M)
    pos_sim = jnp.sum(a * pos, axis=-1) / 0.1
    lse = jax.nn.logsumexp(logits, axis=-1)
    nce = (lse - pos_sim) * valid.ravel()
    desc_loss = jnp.sum(nce) / (jnp.sum(valid) + 1e-6)
    # Keypoint consistency: heatmaps agree across the views (cell level).
    pa = jax.nn.softmax(la_i, axis=-1)[..., :-1].sum(-1)  # cell keypoint-ness
    pb_map = jax.nn.softmax(lb_i, axis=-1)[..., :-1].sum(-1)
    pb_at_a = pb_map[cby, cbx]
    kpt_loss = jnp.sum(((pa - pb_at_a) ** 2) * valid) / (jnp.sum(valid) + 1e-6)
    # Reliability should track descriptor correctness (stop-grad target).
    pos_idx = (cby * Wc + cbx).ravel() + bank_offset
    correct = jax.lax.stop_gradient(
        (jnp.argmax(logits, axis=-1) == pos_idx).astype(jnp.float32)
    )
    rel_loss = jnp.mean((ra_i.ravel() - correct) ** 2 * valid.ravel())
    return desc_loss + kpt_loss + 0.5 * rel_loss


# ---------------------------------------------------------------------------
# Keypoint teacher: the framework's own classical corner response
# ---------------------------------------------------------------------------

def harris_cell_targets(imgs: jnp.ndarray, dustbin_rel: float = 0.02):
    """Per-cell keypoint targets from the classical Harris response.

    imgs: (B, H, W) in [0, 255]. Returns (targets (B, Hc, Wc) int32 in
    [0, 64] — the in-cell argmax position, 64 = dustbin for flat cells —
    and the response maps for debugging).

    WHY: the consistency term alone is minimized by a CONSTANT heatmap,
    which makes top-k keypoint selection non-repeatable noise — the r3
    diagnosis of the learned path's 4-9% synthetic-warp match rate (cell
    -level descriptor accuracy was 25-70% while keypoint matching
    collapsed). Distilling the keypoint head from the framework's own
    corner detector (ops/features._harris — the same role ALIKE plays
    for upstream XFeat) anchors peaks at repeatable, view-covariant
    corners. Self-contained: no external data or teacher network."""
    from stereo_reconstruction_cv_tpu.ops.features import _harris

    B, H, W = imgs.shape
    Hc, Wc = H // CELL, W // CELL
    resp = jax.vmap(_harris)(imgs.astype(jnp.float32) / 255.0)
    cells = resp.reshape(B, Hc, CELL, Wc, CELL).transpose(0, 1, 3, 2, 4)
    cells = cells.reshape(B, Hc, Wc, CELL * CELL)
    pos = jnp.argmax(cells, axis=-1).astype(jnp.int32)
    cmax = jnp.max(cells, axis=-1)
    # Per-image dustbin threshold: a fixed fraction of the crop's peak
    # response (Harris is quartic in contrast, so absolute thresholds
    # don't transfer across crops).
    thr = dustbin_rel * jnp.max(cmax, axis=(1, 2), keepdims=True)
    targets = jnp.where(cmax > thr, pos, jnp.int32(CELL * CELL))
    return targets, resp


def _kpt_teacher_ce(logits, targets, valid=None):
    """Cross-entropy of the 65-way cell logits against teacher targets."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    ce = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    if valid is None:
        return jnp.mean(ce)
    return jnp.sum(ce * valid) / (jnp.sum(valid) + 1e-6)


def xfeat_loss(params, model: XFeatNet, imgs: jnp.ndarray, key) -> jnp.ndarray:
    """Self-supervised homography loss over grayscale images (B, H, W):
    descriptor InfoNCE against a CROSS-BATCH negative bank, heatmap
    consistency, reliability regression, plus the classical-corner
    keypoint teacher (harris_cell_targets) on both views. The warped
    view gets its OWN photometric jitter — real pairs differ in
    exposure, and v2 (same-jitter both views) never saw that."""
    B, H, W = imgs.shape
    allk = jax.random.split(key, B + 2)
    keys, kj1, kj2 = allk[:B], allk[B], allk[B + 1]
    Hms = jax.vmap(lambda k: random_homography(k, H, W))(keys)
    warped = jax.vmap(warp_image)(imgs.astype(jnp.float32), Hms)
    gain = jax.random.uniform(kj1, (B, 1, 1), minval=0.75, maxval=1.3)
    bias = jax.random.uniform(kj2, (B, 1, 1), minval=-18.0, maxval=18.0)
    warped = jnp.clip(warped * gain + bias, 0.0, 255.0)
    # Warp coverage: cells of B whose 8x8 footprint includes out-of-image
    # samples get dustbin teacher targets (the zero border paints strong
    # artificial corners there).
    cover = jax.vmap(warp_image)(jnp.ones_like(imgs, jnp.float32), Hms)
    xa = (imgs.astype(jnp.float32) / 255.0)[..., None]
    xb = (warped / 255.0)[..., None]
    la, da, ra = model.apply(params, xa)
    lb, db, rb = model.apply(params, xb)
    Hc, Wc = da.shape[1:3]
    N = Hc * Wc
    centers = _cell_centers(Hc, Wc)  # (Hc, Wc, 2) in image A
    bank = db.reshape(B * N, db.shape[-1])

    def per_image(i, Hm, da_i, db_i, la_i, lb_i, ra_i):
        ch = jnp.concatenate([centers, jnp.ones_like(centers[..., :1])], axis=-1)
        pb = ch @ Hm.T
        pb = pb[..., :2] / pb[..., 2:3]
        return _cells_loss(da_i, db_i, la_i, lb_i, ra_i, pb,
                           jnp.ones(pb.shape[:2], bool),
                           bank=bank, bank_offset=i * N)

    losses = jax.vmap(per_image)(jnp.arange(B), Hms, da, db, la, lb, ra)
    # Keypoint teacher on both views (each view's own corners).
    ta, _ = harris_cell_targets(imgs.astype(jnp.float32))
    tb, _ = harris_cell_targets(warped)
    cov_cells = cover.reshape(B, Hc, CELL, Wc, CELL).min((2, 4)) > 0.999
    tb = jnp.where(cov_cells, tb, jnp.int32(CELL * CELL))
    kpt_ce = _kpt_teacher_ce(la, ta) + _kpt_teacher_ce(lb, tb)
    return jnp.mean(losses) + 0.5 * kpt_ce


def xfeat_stereo_loss(params, model: XFeatNet, imgsA: jnp.ndarray,
                      imgsB: jnp.ndarray, disp: jnp.ndarray,
                      dvalid: jnp.ndarray) -> jnp.ndarray:
    """Cross-view loss on REAL rectified stereo crops with dense SGBM
    disparity as correspondence supervision (B, H, W each; crops share
    row/column origins so left pixel (u, v) matches right (u - d, v)).

    Homography warps of a single frame keep the exact texture instance,
    so repetitive structures (d3's curtain folds) look perfectly
    matchable in training and the descriptors/reliability never learn to
    disambiguate them — the r3 failure mode behind d3's broken learned
    pose. Real cross-view pairs carry the true appearance change; the
    classical pipeline (rectify + SGBM, itself cv2-gated) bootstraps the
    labels, so the learned matcher is self-supervised by the framework's
    own geometry — no external data."""
    xa = (imgsA.astype(jnp.float32) / 255.0)[..., None]
    xb = (imgsB.astype(jnp.float32) / 255.0)[..., None]
    la, da, ra = model.apply(params, xa)
    lb, db, rb = model.apply(params, xb)
    Hc, Wc = da.shape[1:3]
    centers = _cell_centers(Hc, Wc)
    cyi = (centers[..., 1]).astype(jnp.int32)
    cxi = (centers[..., 0]).astype(jnp.int32)

    def per_pair(da_i, db_i, la_i, lb_i, ra_i, d_i, v_i):
        d_at = d_i[cyi, cxi]
        v_at = v_i[cyi, cxi]
        pb = jnp.stack([centers[..., 0] - d_at, centers[..., 1]], axis=-1)
        return _cells_loss(da_i, db_i, la_i, lb_i, ra_i, pb, v_at)

    losses = jax.vmap(per_pair)(da, db, la, lb, ra, disp, dvalid)
    # Classical-corner keypoint teacher on both real views (see
    # harris_cell_targets for why consistency alone is degenerate).
    ta, _ = harris_cell_targets(imgsA.astype(jnp.float32))
    tb, _ = harris_cell_targets(imgsB.astype(jnp.float32))
    kpt_ce = _kpt_teacher_ce(la, ta) + _kpt_teacher_ce(lb, tb)
    return jnp.mean(losses) + 0.5 * kpt_ce


class TrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    step: jnp.ndarray


def create_train_state(key, model: XFeatNet, input_shape: Tuple[int, int], lr: float = 1e-3):
    H, W = input_shape
    params = model.init(key, jnp.zeros((1, H, W, 1), jnp.float32))
    tx = optax.adam(lr)
    return TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)), tx


def train_step(state: TrainState, tx, model: XFeatNet, imgs: jnp.ndarray, key):
    """One optimizer step. Data-parallel: shard `imgs` over the mesh 'data'
    axis and jit with sharded in_shardings — gradients reduce automatically
    (XLA inserts the psum)."""
    loss, grads = jax.value_and_grad(xfeat_loss)(state.params, model, imgs, key)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss
