"""Guided subpixel match refinement (batched inverse-compositional LK).

The learned detector localizes keypoints to ~0.5-1 px (8-px heatmap cells
+ gradient refinement), which starves cv2-parity E-RANSAC at its fixed
1.0 px threshold (reference gui.py:142) — on dataset/d2 only 29/1314
F-consistent learned matches survived the E gate (docs/XFEAT_EVAL.json,
r3 interim). SIFT sidesteps this with DoG-interpolated keypoints; the
learned path instead refines the MATCH: hold the left point fixed and
slide the right patch to the sub-pixel offset that best aligns the image
content (classic Lucas-Kanade / KLT, the same machinery cv2 users reach
with calcOpticalFlowPyrLK after a coarse matcher).

Device-first shape: every match refines in parallel (vmap over matches), a
fixed iteration count of 2x2 normal-equation solves on bilinearly sampled
patches — the same pattern as calib/chessboard.corner_subpix (the batched
cv2.cornerSubPix), but aligning patch-to-patch ACROSS images instead of
patch-to-saddle within one. Patches are zero-mean-normalized per
iteration, so a global exposure difference between the two frames does
not bias the solve.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _bilinear_patch(img: jnp.ndarray, cx, cy, off: jnp.ndarray):
    """Sample an (n, n) patch centered at (cx, cy) with bilinear interp.
    off: (n,) relative offsets. Coordinates are clipped to the valid
    bilinear domain (border matches are rejected separately)."""
    H, W = img.shape
    xs = jnp.clip(cx + off[None, :], 0.0, W - 1.001)
    ys = jnp.clip(cy + off[:, None], 0.0, H - 1.001)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y0 = jnp.floor(ys).astype(jnp.int32)
    fx = xs - x0
    fy = ys - y0
    v00 = img[y0, x0]
    v10 = img[y0, x0 + 1]
    v01 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy + v11 * fx * fy)


@functools.partial(jax.jit, static_argnames=("win", "iters", "max_shift"))
def refine_matches_lk(
    imgL: jnp.ndarray,
    imgR: jnp.ndarray,
    pts_l: jnp.ndarray,
    pts_r: jnp.ndarray,
    win: int = 7,
    iters: int = 8,
    max_shift: float = 3.0,
):
    """Refine right-image match coordinates by LK alignment to the left
    patch. Returns (refined pts_r, moved) where `moved` is the per-match
    displacement actually applied (0 where the solve diverged).

    imgL/imgR: (H, W) grayscale (uint8 or float). pts_l/pts_r: (N, 2) xy.
    Matches whose refinement drifts beyond `max_shift` px, lands outside
    the image, or sits on a gradient-degenerate patch keep their input
    coordinate — the refinement is strictly opt-in per match."""
    L = imgL.astype(jnp.float32)
    R = imgR.astype(jnp.float32)
    H, W = L.shape
    n = 2 * win + 1
    off = jnp.arange(-win, win + 1, dtype=jnp.float32)

    def one(pl_, pr_):
        # Template: left patch + its gradients (inverse compositional —
        # Hessian assembled once from the TEMPLATE, reused every iter).
        tx, ty = pl_[0], pl_[1]
        T = _bilinear_patch(L, tx, ty, off)
        gx = (_bilinear_patch(L, tx + 0.5, ty, off)
              - _bilinear_patch(L, tx - 0.5, ty, off))
        gy = (_bilinear_patch(L, tx, ty + 0.5, off)
              - _bilinear_patch(L, tx, ty - 0.5, off))
        T = T - jnp.mean(T)
        a = jnp.sum(gx * gx)
        b = jnp.sum(gx * gy)
        c = jnp.sum(gy * gy)
        det = a * c - b * b
        ok0 = det > 1e-6
        inv = jnp.where(ok0, 1.0 / jnp.maximum(det, 1e-6), 0.0)

        def step(_, pr):
            I = _bilinear_patch(R, pr[0], pr[1], off)
            e = (I - jnp.mean(I)) - T
            bx = jnp.sum(gx * e)
            by = jnp.sum(gy * e)
            # Solve H d = b; I(x + d) ~ T  =>  move AGAINST the residual.
            dx = (c * bx - b * by) * inv
            dy = (a * by - b * bx) * inv
            return pr - jnp.stack([dx, dy])

        pr = jax.lax.fori_loop(0, iters, step, pr_)
        d = pr - pr_
        good = (
            ok0
            & (jnp.abs(d[0]) <= max_shift)
            & (jnp.abs(d[1]) <= max_shift)
            & (pr[0] >= win) & (pr[0] <= W - 1 - win)
            & (pr[1] >= win) & (pr[1] <= H - 1 - win)
            & (pl_[0] >= win) & (pl_[0] <= W - 1 - win)
            & (pl_[1] >= win) & (pl_[1] <= H - 1 - win)
        )
        out = jnp.where(good, pr, pr_)
        return out, jnp.where(good, d, jnp.zeros(2, jnp.float32))

    return jax.vmap(one)(
        pts_l.astype(jnp.float32), pts_r.astype(jnp.float32)
    )
