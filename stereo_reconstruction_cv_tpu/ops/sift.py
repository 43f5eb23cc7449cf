"""DoG scale-space SIFT detection with OpenCV's parameter semantics.

Replaces the round-1/2 multi-scale Harris stand-in for
cv2.SIFT_create().detectAndCompute (reference gui.py:112-114, 212 — the
GUI exposes contrastThreshold in [0, 0.1], gui.py:546-553). The Harris
version re-interpreted that threshold as a relative response floor,
which is not cv2's meaning; here the semantics are cv2's own:

  - Gaussian pyramid, sigma0 = 1.6, 3 layers/octave, first octave at 2x
    upsampled resolution (OpenCV's firstOctave = -1 default);
  - difference-of-Gaussians extrema over 26 neighbors (3x3x3);
  - quadratic 3D subpixel refine (one Newton step, dense closed-form
    3x3 solve via the adjugate — no per-candidate gather/LAPACK);
  - absolute contrast test |D_hat| * n_layers < contrast_threshold on
    images scaled to [0, 1] (cv2 adjustLocalExtrema, img_scale = 1/255);
  - edge rejection tr(H)^2/det(H) >= (r+1)^2/r with r = 10.

Everything is dense, static-shape and jit-friendly: per-octave maps are
computed with separable convolutions, the refine solves run as
elementwise cofactor formulas over whole maps, and candidate extraction
is one global top-k. No data-dependent shapes anywhere.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp


SIGMA0 = 1.6          # cv2 SIFT base sigma
N_LAYERS = 3          # cv2 nOctaveLayers default
EDGE_R = 10.0         # cv2 edgeThreshold default
INIT_SIGMA = 0.5      # assumed blur of the input image (cv2 SIFT_INIT_SIGMA)


def _gauss_kernel(sigma: float) -> jnp.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = jnp.arange(-r, r + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian via depthwise conv (XLA fuses the two passes)."""
    if sigma <= 0:
        return img
    k = _gauss_kernel(sigma)
    r = (k.shape[0] - 1) // 2
    x = img[None, None]  # NCHW
    kh = k.reshape(1, 1, 1, -1)
    kv = k.reshape(1, 1, -1, 1)
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (r, r)), mode="edge")
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID")
    x = jnp.pad(x, ((0, 0), (0, 0), (r, r), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), "VALID")
    return x[0, 0]


def _upsample2(img: jnp.ndarray) -> jnp.ndarray:
    H, W = img.shape
    return jax.image.resize(img, (2 * H, 2 * W), "linear")


def num_octaves(H: int, W: int, first_octave: int = -1) -> int:
    """cv2: round(log2(min) - 2) octaves, counted from the base octave."""
    base = min(H, W) * (2 if first_octave < 0 else 1)
    return max(1, int(round(math.log2(max(base, 8)))) - 2)


def gaussian_pyramid(
    img: jnp.ndarray, n_oct: int, first_octave: int = -1
) -> List[List[jnp.ndarray]]:
    """[octave][layer] Gaussian images; N_LAYERS + 3 layers per octave.

    Layer s has blur sigma0 * 2^(s / N_LAYERS) relative to the octave
    base; successive layers are produced by incremental blurs, octave
    o + 1 starts from octave o's layer N_LAYERS decimated 2x (cv2
    buildGaussianPyramid)."""
    imgf = img.astype(jnp.float32)
    if imgf.dtype != img.dtype or img.dtype == jnp.uint8:
        imgf = imgf / 255.0
    if first_octave < 0:
        base = _upsample2(imgf)
        sig_diff = math.sqrt(max(SIGMA0**2 - 4.0 * INIT_SIGMA**2, 0.01))
    else:
        base = imgf
        sig_diff = math.sqrt(max(SIGMA0**2 - INIT_SIGMA**2, 0.01))
    base = _blur(base, sig_diff)

    k = 2.0 ** (1.0 / N_LAYERS)
    # Incremental sigmas between consecutive layers (cv2's sig[] array).
    incr = []
    sig_prev = SIGMA0
    for s in range(1, N_LAYERS + 3):
        sig_total = SIGMA0 * (k ** s)
        incr.append(math.sqrt(sig_total**2 - sig_prev**2))
        sig_prev = sig_total

    pyr: List[List[jnp.ndarray]] = []
    for o in range(n_oct):
        if o == 0:
            g = base
        else:
            g = pyr[o - 1][N_LAYERS][::2, ::2]
        levels = [g]
        for s in range(N_LAYERS + 2):
            g = _blur(g, incr[s])
            levels.append(g)
        pyr.append(levels)
    return pyr


class OctaveExtrema(NamedTuple):
    score: jnp.ndarray   # (H*W*N_LAYERS,) |contrast|, 0 where rejected
    x: jnp.ndarray       # refined x in input-image coords
    y: jnp.ndarray       # refined y
    sigma: jnp.ndarray   # keypoint scale in input-image coords


def _octave_extrema(
    dogs: jnp.ndarray,          # (N_LAYERS + 2, H, W)
    octave: int,
    first_octave: int,
    contrast_threshold: float,
) -> OctaveExtrema:
    """Dense extremum test + one-Newton-step refine for one octave."""
    n, H, W = dogs.shape
    D = dogs  # values in [-1, 1] (input scaled to [0, 1])
    prelim = 0.5 * contrast_threshold / N_LAYERS

    def shifted(a, dy, dx):
        return jnp.roll(a, (-dy, -dx), axis=(-2, -1))

    scores, xs, ys, sigmas = [], [], [], []
    for s in range(1, N_LAYERS + 1):
        cur, lo, hi = D[s], D[s - 1], D[s + 1]
        neigh_max = jnp.full_like(cur, -jnp.inf)
        neigh_min = jnp.full_like(cur, jnp.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                for layer in (lo, cur, hi):
                    if layer is cur and dy == 0 and dx == 0:
                        continue
                    v = shifted(layer, dy, dx)
                    neigh_max = jnp.maximum(neigh_max, v)
                    neigh_min = jnp.minimum(neigh_min, v)
        is_ext = ((cur > neigh_max) | (cur < neigh_min)) & (
            jnp.abs(cur) > prelim
        )
        # Border ring: roll wraps, and cv2 excludes a SIFT_IMG_BORDER=5 rim.
        yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        B = 5
        is_ext &= (yy >= B) & (yy < H - B) & (xx >= B) & (xx < W - B)

        # Quadratic refine: gradient and Hessian of D(x, y, s).
        gx = 0.5 * (shifted(cur, 0, 1) - shifted(cur, 0, -1))
        gy = 0.5 * (shifted(cur, 1, 0) - shifted(cur, -1, 0))
        gs = 0.5 * (hi - lo)
        hxx = shifted(cur, 0, 1) + shifted(cur, 0, -1) - 2 * cur
        hyy = shifted(cur, 1, 0) + shifted(cur, -1, 0) - 2 * cur
        hss = hi + lo - 2 * cur
        hxy = 0.25 * (
            shifted(cur, 1, 1) - shifted(cur, 1, -1)
            - shifted(cur, -1, 1) + shifted(cur, -1, -1)
        )
        hxs = 0.25 * (
            shifted(hi, 0, 1) - shifted(hi, 0, -1)
            - shifted(lo, 0, 1) + shifted(lo, 0, -1)
        )
        hys = 0.25 * (
            shifted(hi, 1, 0) - shifted(hi, -1, 0)
            - shifted(lo, 1, 0) + shifted(lo, -1, 0)
        )
        # Solve H @ off = -g with the adjugate (dense 3x3 Cramer).
        c00 = hyy * hss - hys * hys
        c01 = hxs * hys - hxy * hss
        c02 = hxy * hys - hxs * hyy
        c11 = hxx * hss - hxs * hxs
        c12 = hxy * hxs - hxx * hys
        c22 = hxx * hyy - hxy * hxy
        det = hxx * c00 + hxy * c01 + hxs * c02
        safe = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        off_x = -(c00 * gx + c01 * gy + c02 * gs) / safe
        off_y = -(c01 * gx + c11 * gy + c12 * gs) / safe
        off_s = -(c02 * gx + c12 * gy + c22 * gs) / safe
        # cv2 iterates while |off| > 0.5 walking to the neighbor pixel;
        # a single step keeps only well-centered extrema (the walked-to
        # candidates re-appear as extrema at their own pixel).
        centered = (
            (jnp.abs(off_x) < 0.6) & (jnp.abs(off_y) < 0.6) & (jnp.abs(off_s) < 0.6)
        )
        contr = cur + 0.5 * (gx * off_x + gy * off_y + gs * off_s)
        pass_contrast = jnp.abs(contr) * N_LAYERS >= contrast_threshold
        # Edge response on the 2D Hessian.
        tr = hxx + hyy
        det2 = hxx * hyy - hxy * hxy
        pass_edge = (det2 > 0) & (
            tr * tr * EDGE_R < (EDGE_R + 1) ** 2 * det2
        )
        keep = is_ext & centered & pass_contrast & pass_edge

        scale = float(2.0 ** (octave + first_octave))  # octave -> input px
        kx = (xx.astype(jnp.float32) + off_x) * scale
        ky = (yy.astype(jnp.float32) + off_y) * scale
        ksig = (
            SIGMA0
            * jnp.exp2((s + off_s) / N_LAYERS)
            * scale
        )
        scores.append(jnp.where(keep, jnp.abs(contr), 0.0).ravel())
        xs.append(kx.ravel())
        ys.append(ky.ravel())
        sigmas.append(ksig.ravel())
    return OctaveExtrema(
        jnp.concatenate(scores), jnp.concatenate(xs),
        jnp.concatenate(ys), jnp.concatenate(sigmas),
    )


class ScaleSpaceResult(NamedTuple):
    keypoints: jnp.ndarray   # (K, 2) xy input-image pixels
    scores: jnp.ndarray      # (K,) |contrast| (0 = invalid slot)
    sigmas: jnp.ndarray      # (K,)
    num_detected: jnp.ndarray  # () total extrema passing all tests


@functools.partial(
    jax.jit, static_argnames=("max_keypoints", "first_octave", "shape")
)
def _detect_impl(img, max_keypoints, first_octave, shape, contrast_threshold):
    H, W = shape
    n_oct = num_octaves(H, W, first_octave)
    pyr = gaussian_pyramid(img, n_oct, first_octave)
    per_oct = []
    for o, levels in enumerate(pyr):
        dogs = jnp.stack([levels[i + 1] - levels[i] for i in range(N_LAYERS + 2)])
        per_oct.append(
            _octave_extrema(dogs, o, first_octave, contrast_threshold)
        )
    score = jnp.concatenate([e.score for e in per_oct])
    xs = jnp.concatenate([e.x for e in per_oct])
    ys = jnp.concatenate([e.y for e in per_oct])
    sig = jnp.concatenate([e.sigma for e in per_oct])
    num = jnp.sum(score > 0).astype(jnp.int32)
    top, idx = jax.lax.top_k(score, max_keypoints)
    return ScaleSpaceResult(
        jnp.stack([xs[idx], ys[idx]], axis=-1), top, sig[idx], num
    )


def detect_scale_space(
    img: jnp.ndarray,
    contrast_threshold: float = 0.04,
    max_keypoints: int = 4096,
    first_octave: int = -1,
) -> ScaleSpaceResult:
    """cv2.SIFT-semantics keypoint detection. img: (H, W) uint8/float.

    Returns the top `max_keypoints` by refined contrast plus the dense
    count of ALL extrema passing cv2's contrast/edge tests (the
    keypoint-count parity metric for the threshold-sweep test)."""
    H, W = img.shape
    return _detect_impl(
        img, max_keypoints, first_octave, (H, W),
        jnp.float32(contrast_threshold),
    )
