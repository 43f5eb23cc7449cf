"""Chessboard corner detection + subpixel refinement.

Replaces cv2.findChessboardCorners + cv2.cornerSubPix (reference
gui.py:49-57, main.ipynb cell 1). Device/host split (SURVEY §7 hard part 2):

  device: saddle-point response (Hessian determinant of a smoothed image),
          non-max suppression, batched subpixel refinement — dense,
          data-parallel XLA ops over the 4K image / all corners at once.
  host:   grid assembly — growing the 9x7 integer lattice from candidate
          corners by local-homography prediction (irregular, graph-shaped,
          tiny: O(100) candidates).

Output convention matches cv2: corners ordered row-major along the board's
(cols, rows) grid so they pair with calib.zhang.build_object_points.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Device side: response, NMS, subpixel
# ---------------------------------------------------------------------------

def _gauss_kernel(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _sep_conv(img: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Separable 2D convolution with edge padding."""
    r = (k.shape[0] - 1) // 2
    p = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    img = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"), in_axes=1, out_axes=1)(p)
    p = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    img = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(p)
    return img


def saddle_response(img: jnp.ndarray, sigma: float = 2.0) -> jnp.ndarray:
    """Negative-determinant-of-Hessian response: chessboard X-corners are
    strong saddles (det H < 0); blobs/edges are suppressed. (H, W) f32."""
    g = _sep_conv(img.astype(jnp.float32), _gauss_kernel(sigma, int(3 * sigma)))
    dy, dx = jnp.gradient(g)
    dyy, dyx = jnp.gradient(dy)
    dxy, dxx = jnp.gradient(dx)
    det = dxx * dyy - 0.25 * (dxy + dyx) ** 2
    return jnp.maximum(-det, 0.0)


def nms_candidates(
    response: jnp.ndarray, num: int = 256, radius: int = 5
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-`num` local maxima of the response. Returns ((num, 2) xy, (num,)
    scores); padded entries have score 0."""
    H, W = response.shape
    r = radius
    p = jnp.pad(response, r, mode="constant")
    win = jnp.stack(
        [
            p[r + dy : r + dy + H, r + dx : r + dx + W]
            for dy in range(-r, r + 1)
            for dx in range(-r, r + 1)
            if not (dy == 0 and dx == 0)
        ]
    )
    is_max = jnp.all(response >= win, axis=0) & (response > 0)
    flat = jnp.where(is_max, response, 0.0).ravel()
    scores, idx = jax.lax.top_k(flat, num)
    ys = idx // W
    xs = idx % W
    return jnp.stack([xs, ys], axis=-1).astype(jnp.float32), scores


def corner_subpix(
    img: jnp.ndarray,
    corners: jnp.ndarray,
    win: int = 11,
    max_iter: int = 30,
    eps: float = 0.001,
) -> jnp.ndarray:
    """Batched cv2.cornerSubPix: gradient-weighted least-squares refinement.

    Minimizes sum_w (∇I(p) · (p - q))^2 over window points p for corner q;
    each iteration solves a 2x2 normal system on a bilinearly-sampled
    window. All corners refine in parallel (vmap); the iteration count is
    fixed (masked convergence) for jit. Matches cv2's termination
    (EPS+MAX_ITER, 30, 0.001) and 11x11 half-window default (gui.py:29,57).
    """
    imgf = img.astype(jnp.float32)
    H, W = imgf.shape
    # cv2 uses a (2*win+1)^2 window with a separable triangular-ish weight.
    n = 2 * win + 1
    off = jnp.arange(-win, win + 1, dtype=jnp.float32)
    wx = 1.0 - jnp.abs(off) / (win + 1)
    weight = wx[:, None] * wx[None, :]

    def bilinear(y, x):
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = x - x0
        fy = y - y0
        x0c = jnp.clip(x0, 0, W - 2)
        y0c = jnp.clip(y0, 0, H - 2)
        v00 = imgf[y0c, x0c]
        v10 = imgf[y0c, x0c + 1]
        v01 = imgf[y0c + 1, x0c]
        v11 = imgf[y0c + 1, x0c + 1]
        return (
            v00 * (1 - fx) * (1 - fy)
            + v10 * fx * (1 - fy)
            + v01 * (1 - fx) * fy
            + v11 * fx * fy
        )

    gy_off, gx_off = jnp.meshgrid(off, off, indexing="ij")

    def refine_one(q):
        def body(_, q):
            cx, cy = q[0], q[1]
            ys = cy + gy_off
            xs = cx + gx_off
            # Central-difference gradients on the sampled window.
            gx = (bilinear(ys, xs + 1.0) - bilinear(ys, xs - 1.0)) * 0.5
            gy = (bilinear(ys + 1.0, xs) - bilinear(ys - 1.0, xs)) * 0.5
            a = jnp.sum(weight * gx * gx)
            b = jnp.sum(weight * gx * gy)
            c = jnp.sum(weight * gy * gy)
            bx = jnp.sum(weight * (gx * gx * xs + gx * gy * ys))
            by = jnp.sum(weight * (gx * gy * xs + gy * gy * ys))
            det = a * c - b * b
            ok = jnp.abs(det) > 1e-12
            nx = jnp.where(ok, (c * bx - b * by) / jnp.where(ok, det, 1.0), cx)
            ny = jnp.where(ok, (a * by - b * bx) / jnp.where(ok, det, 1.0), cy)
            # Guard against divergence.
            nx = jnp.clip(nx, cx - 2.0, cx + 2.0)
            ny = jnp.clip(ny, cy - 2.0, cy + 2.0)
            return jnp.array([nx, ny])

        return jax.lax.fori_loop(0, max_iter, body, q)

    return jax.vmap(refine_one)(corners.astype(jnp.float32))


def corner_subpix_patch(
    img: jnp.ndarray,
    corners: jnp.ndarray,
    win: int = 3,
    max_iter: int = 5,
    max_drift: float = 3.0,
) -> jnp.ndarray:
    """Patch-resident corner_subpix for LARGE keypoint sets (the learned
    detector's per-frame refinement, models/xfeat._detect_post).

    `corner_subpix` bilinearly samples the full image 4x per window point
    per iteration — ~4M scalar gathers for 1024 keypoints at win=3. Here
    each corner instead extracts ONE (P, P)
    patch around its initial integer location, and every iteration
    resamples the shifted window INSIDE the patch as two small batched
    matmuls (separable bilinear: S = Wy @ patch @ Wx^T) — gather-free
    after the single patch fetch.

    Iterates the same gradient-weighted 2x2 normal solve as
    `corner_subpix`; results match wherever the refinement stays within
    `max_drift` of the start (beyond that the patch clamps — such points
    are exactly the ones detect's 1.5 px acceptance gate rejects anyway).
    cv2.cornerSubPix semantics: gui.py:57 (the calib stack keeps the
    full-image variant)."""
    imgf = img.astype(jnp.float32)
    H, W = imgf.shape
    n = 2 * win + 1
    off = jnp.arange(-win, win + 1, dtype=jnp.float32)
    wx = 1.0 - jnp.abs(off) / (win + 1)
    weight = wx[:, None] * wx[None, :]
    gy_off, gx_off = jnp.meshgrid(off, off, indexing="ij")

    drift = int(np.ceil(max_drift))
    # Samples reach +-(win+1) around the current center (gradients need
    # one extra texel), the center may drift +-drift, and bilinear reads
    # one texel past floor.
    half = win + 2 + drift
    P = 2 * half + 1
    m = n + 2  # sampled grid rows/cols: window plus gradient margin

    # Edge-pad the image by `half` so border keypoints keep a correctly
    # CENTERED patch (clipping x0/y0 instead recentred the patch and the
    # solve then iterated around the wrong point — r4 review finding:
    # such keypoints could pass the 1.5 px gate at a shifted position).
    # Border samples see edge-replicated texels, close to (not identical
    # to) corner_subpix's index-clamped bilinear blend at the frame edge.
    padded = jnp.pad(imgf, half, mode="edge")
    x0 = jnp.clip(jnp.floor(corners[:, 0]).astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(jnp.floor(corners[:, 1]).astype(jnp.int32), 0, H - 1)
    rng = jnp.arange(0, P)  # padded-coord offsets: center x0 maps to x0+half
    patches = padded[
        (y0[:, None, None] + rng[None, :, None]),
        (x0[:, None, None] + rng[None, None, :]),
    ]  # (N, P, P), one gather; patch midpoint = image pixel (x0, y0)

    kk = jnp.arange(P, dtype=jnp.float32)
    moff = jnp.arange(-(win + 1), win + 2, dtype=jnp.float32)  # (m,)
    lim = float(half - win - 2)  # max |center - patch midpoint| that keeps
    #                              every sample (incl. bilinear +1) inside

    def interp_weights(c_patch):
        # (m, P) separable bilinear weights for positions c_patch + moff,
        # in patch coordinates [0, P).
        pos = c_patch + moff
        f0 = jnp.floor(pos)
        fr = pos - f0
        d = kk[None, :] - f0[:, None]
        return jnp.where(d == 0, 1.0 - fr[:, None], 0.0) + jnp.where(
            d == 1, fr[:, None], 0.0
        )

    def refine_one(q, patch, x0i, y0i):
        ox = x0i.astype(jnp.float32)  # patch-midpoint image coords
        oy = y0i.astype(jnp.float32)

        def body(_, c):
            # Patch coords (midpoint at `half`); the normal equations are
            # affine-invariant, so solving in patch coords is exact.
            cxp = jnp.clip(c[0], half - lim, half + lim)
            cyp = jnp.clip(c[1], half - lim, half + lim)
            S = interp_weights(cyp) @ patch @ interp_weights(cxp).T  # (m, m)
            gx = (S[1:-1, 2:] - S[1:-1, :-2]) * 0.5  # (n, n)
            gy = (S[2:, 1:-1] - S[:-2, 1:-1]) * 0.5
            xs = cxp + gx_off
            ys = cyp + gy_off
            a = jnp.sum(weight * gx * gx)
            b = jnp.sum(weight * gx * gy)
            cc = jnp.sum(weight * gy * gy)
            bx = jnp.sum(weight * (gx * gx * xs + gx * gy * ys))
            by = jnp.sum(weight * (gx * gy * xs + gy * gy * ys))
            det = a * cc - b * b
            ok = jnp.abs(det) > 1e-12
            nx = jnp.where(ok, (cc * bx - b * by) / jnp.where(ok, det, 1.0), cxp)
            ny = jnp.where(ok, (a * by - b * bx) / jnp.where(ok, det, 1.0), cyp)
            nx = jnp.clip(nx, cxp - 2.0, cxp + 2.0)
            ny = jnp.clip(ny, cyp - 2.0, cyp + 2.0)
            return jnp.array([nx, ny])

        c_init = jnp.array([q[0] - ox + half, q[1] - oy + half])
        c_fin = jax.lax.fori_loop(0, max_iter, body, c_init)
        return jnp.array([c_fin[0] - half + ox, c_fin[1] - half + oy])

    return jax.vmap(refine_one)(corners.astype(jnp.float32), patches, x0, y0)


# ---------------------------------------------------------------------------
# Host side: lattice growth
# ---------------------------------------------------------------------------

def _grow_grid(cands: np.ndarray, scores: np.ndarray, cols: int, rows: int):
    """Assemble a cols x rows corner lattice from candidates (host, numpy).

    Strategy: seed at the strongest central candidate, estimate the two
    lattice vectors from its nearest neighbors, then repeatedly predict
    missing grid positions by local linear extrapolation and snap to the
    nearest unused candidate. Returns (cols*rows, 2) ordered row-major, or
    None if the full grid can't be assembled."""
    n = (scores > 0).sum()
    cands = cands[:n]
    scores = scores[:n]
    if n < cols * rows:
        return None
    # Weak saddles also fire between squares (diagonal crossings); true
    # corners form a clear score plateau. Keep candidates within a relative
    # band of the expected-corner median score.
    thresh = 0.3 * np.median(scores[: cols * rows])
    keep = scores >= thresh
    cands = cands[keep]
    scores = scores[keep]
    n = len(cands)
    if n < cols * rows:
        return None
    # Seed: strongest candidate near the centroid of all candidates.
    center = cands.mean(axis=0)
    d2c = np.linalg.norm(cands - center, axis=1)
    seed = int(np.argmin(d2c - 1e-3 * scores))
    # Lattice vectors: the two shortest, non-collinear neighbor offsets.
    d = cands - cands[seed]
    dist = np.linalg.norm(d, axis=1)
    order = np.argsort(dist)
    v1 = None
    v2 = None
    for i in order[1:]:
        if dist[i] < 1e-3:
            continue
        if v1 is None:
            v1 = d[i]
            continue
        cosang = abs(np.dot(v1, d[i])) / (np.linalg.norm(v1) * dist[i])
        if cosang < 0.7 and dist[i] < 2.5 * np.linalg.norm(v1):
            v2 = d[i]
            break
    if v1 is None or v2 is None:
        return None

    # Integer coordinates by greedy BFS growth with local prediction.
    coords = {seed: (0, 0)}  # candidate index -> lattice coordinate
    occupied = {(0, 0): seed}
    frontier = [(0, 0)]
    basis = {(0, 0): (v1.copy(), v2.copy())}
    snap_tol = 0.35 * min(np.linalg.norm(v1), np.linalg.norm(v2))
    used = np.zeros(n, bool)
    used[seed] = True

    def neighbors(ij):
        i, j = ij
        return [(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)]

    while frontier:
        cur = frontier.pop(0)
        ci = occupied[cur]
        b1, b2 = basis[cur]
        for nb in neighbors(cur):
            if nb in occupied:
                continue
            di, dj = nb[0] - cur[0], nb[1] - cur[1]
            pred = cands[ci] + di * b1 + dj * b2
            d2 = np.linalg.norm(cands - pred, axis=1)
            d2[used] = np.inf
            j = int(np.argmin(d2))
            if d2[j] > snap_tol:
                continue
            occupied[nb] = j
            coords[j] = nb
            used[j] = True
            # Update local basis from the actual step taken.
            step = cands[j] - cands[ci]
            nb1, nb2 = b1.copy(), b2.copy()
            if di:
                nb1 = step / di
            else:
                nb2 = step / dj
            basis[nb] = (nb1, nb2)
            frontier.append(nb)

    if len(occupied) < cols * rows:
        return None
    ij = np.array(list(occupied.keys()))
    imin, jmin = ij.min(axis=0)
    imax, jmax = ij.max(axis=0)
    span_i = imax - imin + 1
    span_j = jmax - jmin + 1
    # Find a full cols x rows (or rows x cols) sub-window.
    for (ci_, cj_), transpose in (((cols, rows), False), ((rows, cols), True)):
        for i0 in range(imin, imax - ci_ + 2):
            for j0 in range(jmin, jmax - cj_ + 2):
                want = [(i0 + a, j0 + b) for b in range(cj_) for a in range(ci_)]
                if all(w in occupied for w in want):
                    pts = np.array([cands[occupied[w]] for w in want])
                    grid = pts.reshape(cj_, ci_, 2)
                    if transpose:
                        grid = grid.transpose(1, 0, 2)
                        grid = grid.reshape(rows, cols, 2)
                    else:
                        grid = grid.reshape(rows, cols, 2)
                    return _canonical_order(grid)
    return None


def _canonical_order(grid: np.ndarray) -> np.ndarray:
    """Orient a (rows, cols, 2) grid canonically: first row is the top edge
    (smaller mean y), first column the left edge (smaller mean x). Matches
    the deterministic ordering calibrate_camera pairs with object points."""
    if grid[0, :, 1].mean() > grid[-1, :, 1].mean():
        grid = grid[::-1]
    if grid[:, 0, 0].mean() > grid[:, -1, 0].mean():
        grid = grid[:, ::-1]
    return grid.reshape(-1, 2)


def find_chessboard_corners(
    img: jnp.ndarray,
    cols: int = 9,
    rows: int = 7,
    num_candidates: int = 256,
    detect_scale: int = 4,
    subpix_win: int = 11,
):
    """Full detection: response + NMS at reduced scale, grid growth on host,
    subpixel refinement at full resolution.

    Returns (found: bool, corners (cols*rows, 2) float32 or None).
    """
    img = jnp.asarray(img)
    if img.ndim == 3:
        img = jnp.round(
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        )
    H, W = img.shape
    s = detect_scale
    small = img[: H - H % s, : W - W % s].reshape(H // s, s, W // s, s).mean((1, 3))
    resp = saddle_response(small, sigma=2.0)
    cands, scores = nms_candidates(resp, num=num_candidates, radius=4)
    grid = _grow_grid(np.asarray(cands), np.asarray(scores), cols, rows)
    if grid is None and s > 2:
        # Retry at finer scale (small boards in large images).
        s = 2
        small = img[: H - H % s, : W - W % s].reshape(H // s, s, W // s, s).mean((1, 3))
        resp = saddle_response(small, sigma=2.0)
        cands, scores = nms_candidates(resp, num=num_candidates, radius=4)
        grid = _grow_grid(np.asarray(cands), np.asarray(scores), cols, rows)
    if grid is None:
        return False, None
    full = jnp.asarray(grid * s + (s - 1) / 2.0, dtype=jnp.float32)
    refined = corner_subpix(img, full, win=subpix_win)
    return True, refined
