"""Dense disparity: semi-global block matching (SGBM) in JAX.

Replaces cv2.StereoSGBM_create().compute — THE hot loop of the reference
(main.ipynb cell 10, exact parameter set in config.SGBMConfig). Each stage
is a dense, static-shape array program:

  x-Sobel prefilter (clipped)      -> elementwise stencil
  Birchfield-Tomasi cost volume    -> shifted slices over d
  block aggregation (11x11 SAD)    -> separable box filter
  semi-global path aggregation     -> Pallas sweeps through Triton on a
                                      GPU (ops/pallas/sgm_triton.py),
                                      exact lax.scan recurrences elsewhere
  WTA + uniqueness + subpixel      -> reductions over d
  left-right consistency           -> winner-scatter dual over d
  speckle filter                   -> label-propagation connected components

Direction sets mirror OpenCV: the default MODE_SGBM aggregates the 5 paths
{left, right, up-left, up, up-right}; MODE_HH uses all 8. Integer
arithmetic (int32) reproduces OpenCV's floor-division half-pixel
interpolation so costs agree exactly.

All stages are batched-friendly (vmap a leading axis) and static-shape.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.config import SGBMConfig

# OpenCV's fixed-point scale; we return float disparity directly but keep
# the constant for parity notes (output equals cv2's int16 result / 16.0).
DISP_SCALE = 16
# cv2 default MODE_SGBM aggregates 5 paths (empirically verified to 99.7%
# pixel agreement): both horizontals plus the three from the row above.
# Path steps r = (dx, dy); predecessor of p is p - r.
DIRS_5 = ((1, 0), (-1, 0), (1, 1), (0, 1), (-1, 1))
DIRS_8 = ((1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1))


# ---------------------------------------------------------------------------
# Prefilter
# ---------------------------------------------------------------------------

def xsobel_clip(img: jnp.ndarray, cap: int = 63) -> jnp.ndarray:
    """Clipped horizontal Sobel, OpenCV SGBM prefilter semantics.

    d = (I[y-1,x+1]-I[y-1,x-1]) + 2(I[y,x+1]-I[y,x-1]) + (I[y+1,x+1]-I[y+1,x-1])
    out = clip(d, -cap, cap) + cap  in [0, 2*cap].  Border: replicate.
    """
    img = img.astype(jnp.int32)
    p = jnp.pad(img, 1, mode="edge")
    dx = (
        (p[:-2, 2:] - p[:-2, :-2])
        + 2 * (p[1:-1, 2:] - p[1:-1, :-2])
        + (p[2:, 2:] - p[2:, :-2])
    )
    return jnp.clip(dx, -cap, cap) + cap


# ---------------------------------------------------------------------------
# Birchfield-Tomasi cost volume
# ---------------------------------------------------------------------------

def _halfpixel_range(row_img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel min/max over {v, (v+v_left)//2, (v+v_right)//2} (int floor
    division, as OpenCV). (H, W) -> (lo, hi) each (H, W)."""
    v = row_img
    vl = jnp.concatenate([v[:, :1], (v[:, 1:] + v[:, :-1]) // 2], axis=1)
    vr = jnp.concatenate([(v[:, 1:] + v[:, :-1]) // 2, v[:, -1:]], axis=1)
    lo = jnp.minimum(jnp.minimum(vl, vr), v)
    hi = jnp.maximum(jnp.maximum(vl, vr), v)
    return lo, hi


def _bt_plane(
    left: jnp.ndarray, right: jnp.ndarray, num_disp: int, min_disp: int
) -> jnp.ndarray:
    """Symmetric BT cost for one plane -> (H, W, D) int32. C[y, x, d]
    compares left pixel x with right pixel x - (min_disp + d), edge-clamped
    (mirrors OpenCV's padded row buffers)."""
    H, W = left.shape
    llo, lhi = _halfpixel_range(left)
    rlo, rhi = _halfpixel_range(right)
    # Static shifted slices (one fused pad+slice per d) instead of gathers —
    # XLA lowers these to plain windowed reads, ~5x faster than gather.
    pad_lo = num_disp - 1 + min_disp
    edge = [(0, 0), (max(pad_lo, 0), 0)]

    def shifted(a, d):
        s = min_disp + d
        ap = jnp.pad(a, edge, mode="edge")
        return jax.lax.slice_in_dim(ap, pad_lo - s, pad_lo - s + W, axis=1)

    outs = []
    for d in range(num_disp):
        rv = shifted(right, d)
        r0 = shifted(rlo, d)
        r1 = shifted(rhi, d)
        c0 = jnp.maximum(jnp.maximum(left - r1, r0 - left), 0)
        c1 = jnp.maximum(jnp.maximum(rv - lhi, llo - rv), 0)
        outs.append(jnp.minimum(c0, c1))
    return jnp.stack(outs, axis=-1).astype(jnp.int32)


def bt_cost_volume(
    left_sobel: jnp.ndarray,
    right_sobel: jnp.ndarray,
    left_raw: jnp.ndarray,
    right_raw: jnp.ndarray,
    num_disp: int,
    min_disp: int = 0,
) -> jnp.ndarray:
    """OpenCV SGBM pixel cost: BT on the clipped-Sobel plane plus a
    quarter-weighted BT term on raw intensity (stereosgbm's second
    prow plane with diff_scale=2). -> (H, W, D) int32."""
    c_sobel = _bt_plane(left_sobel, right_sobel, num_disp, min_disp)
    c_raw = _bt_plane(
        left_raw.astype(jnp.int32), right_raw.astype(jnp.int32), num_disp, min_disp
    )
    # Per-pixel cost <= 2*cap + 255>>2 = 189; the 11x11 block sum tops out
    # at 22869 — int16 storage halves cost-volume memory traffic.
    return (c_sobel + (c_raw >> 2)).astype(jnp.int16)


def block_sum(vol: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """SAD aggregation: (H, W, D) -> same shape, each entry the sum over a
    block_size x block_size spatial window (edge-replicated, OpenCV clamps
    the window to the image which is equivalent for interior-dominant use).
    Separable two-pass running sum. Integer inputs accumulate in int32
    (window sums overflow int16) and are stored back at the input width."""
    r = block_size // 2
    dtype_in = vol.dtype
    if jnp.issubdtype(dtype_in, jnp.integer):
        vol = vol.astype(jnp.int32)

    def box1d(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r + 1, r)
        xp = jnp.pad(x, pad, mode="edge")
        cs = jnp.cumsum(xp, axis=axis)
        hi = jax.lax.slice_in_dim(cs, block_size, block_size + x.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(cs, 0, x.shape[axis], axis=axis)
        return hi - lo

    return box1d(box1d(vol, 0), 1).astype(dtype_in)


# ---------------------------------------------------------------------------
# Semi-global aggregation
# ---------------------------------------------------------------------------

def _sgm_step(prev: jnp.ndarray, cost: jnp.ndarray, p1: int, p2: int) -> jnp.ndarray:
    """One DP step of L_r(p, d) = C + min(Lp[d], Lp[d∓1]+P1, minLp+P2) - minLp.

    prev, cost: (..., D). Shifts along d are edge-padded with a large value
    so d=0 / d=D-1 see no phantom neighbor.
    """
    big = jnp.asarray(1 << 29, prev.dtype)
    up = jnp.concatenate([prev[..., 1:], jnp.full_like(prev[..., :1], big)], axis=-1)
    dn = jnp.concatenate([jnp.full_like(prev[..., :1], big), prev[..., :-1]], axis=-1)
    min_prev = jnp.min(prev, axis=-1, keepdims=True)
    best = jnp.minimum(jnp.minimum(prev, min_prev + p2), jnp.minimum(up, dn) + p1)
    return cost + best - min_prev


def _shift_cols(a: jnp.ndarray, shift: int) -> jnp.ndarray:
    """Shift along axis -2 (the column axis of a (..., W, D) carry), zero fill."""
    if shift > 0:
        return jnp.concatenate(
            [a[..., shift:, :], jnp.zeros_like(a[..., :shift, :])], axis=-2
        )
    return jnp.concatenate(
        [jnp.zeros_like(a[..., shift:, :]), a[..., :shift, :]], axis=-2
    )


def _chunked_scan(seq: jnp.ndarray, step, chunk: int | None, halo: int) -> jnp.ndarray:
    """Run the DP recurrence along axis 0 of `seq`, optionally chunked.

    chunk=None: exact sequential lax.scan (N steps).
    chunked: split into N/chunk blocks scanned *in parallel*, each warm-
    started from `halo` extra leading elements with a zero carry (SGM path
    influence decays geometrically under P2 normalization, so a 32-element
    halo reproduces the exact scan almost everywhere). Cuts the sequential
    depth from N to chunk+halo and multiplies the per-step vector width by
    N/chunk.
    """

    def plain(s):
        f = lambda carry, c: (lambda L: (L, L))(step(carry, c))
        _, out = jax.lax.scan(f, jnp.zeros_like(s[0]), s)
        return out

    N = seq.shape[0]
    if chunk is None or N <= chunk + halo:
        return plain(seq)
    halo = min(halo, chunk)
    nc = -(-N // chunk)
    npad = nc * chunk
    seqp = jnp.pad(seq, [(0, npad - N)] + [(0, 0)] * (seq.ndim - 1))
    chunks = seqp.reshape(nc, chunk, *seq.shape[1:])
    halos = jnp.concatenate(
        [jnp.zeros_like(chunks[:1, :halo]), chunks[:-1, chunk - halo :]], axis=0
    )
    ext = jnp.moveaxis(jnp.concatenate([halos, chunks], axis=1), 1, 0)
    out = plain(ext)[halo:]  # (chunk, nc, ...)
    out = jnp.moveaxis(out, 0, 1).reshape(npad, *seq.shape[1:])
    return out[:N]


def _scan_dir(
    C: jnp.ndarray, dx: int, dy: int, p1: int, p2: int,
    chunk: int | None = 64, halo: int = 32,
) -> jnp.ndarray:
    """Aggregate along one path direction r=(dx, dy). C: (H, W, D) int32.

    Paths with dy != 0 scan over rows (carry (..., W, D), shifted by dx per
    step for diagonals); dy == 0 scans over columns (carry (..., H, D)).
    Zero-initialized carries make boundary pixels reduce to L = C exactly
    (min(0, 0+P1, 0+P2) - 0 == 0), matching the path-start convention.
    """
    if dy == 0:
        # Horizontal: scan along x; flip so the scan always runs "forward".
        vol = C if dx > 0 else C[:, ::-1]
        seq = jnp.moveaxis(vol, 1, 0)  # (W, H, D)
        out = _chunked_scan(seq, lambda p, c: _sgm_step(p, c, p1, p2), chunk, halo)
        out = jnp.moveaxis(out, 0, 1)
        return out if dx > 0 else out[:, ::-1]

    vol = C if dy > 0 else C[::-1]
    if dx != 0:
        # Diagonal: predecessor is one column over in the previous row.
        shift = -dx  # carry[x] must come from prev row at x - dx
        step = lambda p, c: _sgm_step(_shift_cols(p, shift), c, p1, p2)
    else:
        step = lambda p, c: _sgm_step(p, c, p1, p2)
    out = _chunked_scan(vol, step, chunk, halo)
    return out if dy > 0 else out[::-1]


def sgm_aggregate(
    C: jnp.ndarray,
    p1: int,
    p2: int,
    directions: Sequence[Tuple[int, int]] = DIRS_8,
    chunk: int | None = 64,
    halo: int = 32,
) -> jnp.ndarray:
    """Sum of per-direction DP aggregations. (H, W, D) -> (H, W, D) int32."""
    C = C.astype(jnp.int32)  # cost may be stored int16; sums need int32
    S = jnp.zeros_like(C)
    for dx, dy in directions:
        S = S + _scan_dir(C, dx, dy, p1, p2, chunk, halo)
    return S


def sgm_aggregate_exact(
    C: jnp.ndarray, p1: int, p2: int, directions: Sequence[Tuple[int, int]]
) -> jnp.ndarray:
    """`sgm_aggregate(C, p1, p2, directions, chunk=None)`, by the fastest
    route of the platform the computation is lowered for: the Triton
    sweeps on CUDA (bit-identical), the XLA scans elsewhere."""

    def xla(c):
        return sgm_aggregate(c, p1, p2, directions, chunk=None)

    def triton(c):
        from stereo_reconstruction_cv_tpu.ops.pallas.sgm_triton import (
            sgm_aggregate_triton,
        )

        return sgm_aggregate_triton(c, p1, p2, directions)

    return jax.lax.platform_dependent(C, cuda=triton, default=xla)


def sgm_aggregate_auto(C: jnp.ndarray, cfg: SGBMConfig) -> jnp.ndarray:
    """Path aggregation for `cfg`: exact by `sgm_aggregate_exact`, unless
    cfg.scan_chunk asks for the chunked scan, an approximation the sweeps
    do not implement, which always takes the XLA route."""
    dirs = DIRS_8 if cfg.num_directions == 8 else DIRS_5
    if cfg.scan_chunk is not None:
        return sgm_aggregate(C, cfg.p1, cfg.p2, dirs, cfg.scan_chunk, cfg.scan_halo)
    return sgm_aggregate_exact(C, cfg.p1, cfg.p2, dirs)


# ---------------------------------------------------------------------------
# Disparity selection
# ---------------------------------------------------------------------------

def wta_disparity(
    S: jnp.ndarray,
    min_disp: int,
    uniqueness_ratio: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Winner-take-all with OpenCV's uniqueness test and quadratic subpixel.

    Returns (float disparity incl. min_disp offset, valid mask)."""
    D = S.shape[-1]
    best = jnp.argmin(S, axis=-1)
    minS = jnp.min(S, axis=-1)
    # Uniqueness (cv2): invalid if some d with |d - best| > 1 has
    # S[d]*(100 - ratio) < minS*100.
    d_idx = jax.lax.broadcasted_iota(jnp.int32, S.shape, S.ndim - 1)
    far = jnp.abs(d_idx - best[..., None]) > 1
    close_cost = (S * (100 - uniqueness_ratio) < minS[..., None] * 100) & far
    valid = ~jnp.any(close_cost, axis=-1)
    # Subpixel: d + (S[d-1] - S[d+1]) / (2 * max(S[d-1]+S[d+1]-2S[d], 1)).
    # S[best±1] as one-hot masked reductions over d.
    bm1 = jnp.clip(best - 1, 0, D - 1)
    bp1 = jnp.clip(best + 1, 0, D - 1)
    Sm1 = jnp.sum(jnp.where(d_idx == bm1[..., None], S, 0), axis=-1)
    Sp1 = jnp.sum(jnp.where(d_idx == bp1[..., None], S, 0), axis=-1)
    denom = jnp.maximum(Sm1 + Sp1 - 2 * minS, 1).astype(jnp.float32)
    frac = (Sm1 - Sp1).astype(jnp.float32) / (2.0 * denom)
    interior = (best > 0) & (best < D - 1)
    disp = best.astype(jnp.float32) + jnp.where(interior, frac, 0.0) + float(min_disp)
    return disp, valid


def lr_check(
    S: jnp.ndarray,
    disp: jnp.ndarray,
    min_disp: int,
    max_diff: int,
) -> jnp.ndarray:
    """Left-right consistency from the aggregated volume (XLA path)."""
    best = jnp.argmin(S, axis=-1).astype(jnp.int32)
    minS = jnp.min(S, axis=-1)
    return lr_check_maps(best, minS, disp, S.shape[-1], min_disp, max_diff)


def lr_check_maps(
    best: jnp.ndarray,
    minS: jnp.ndarray,
    disp: jnp.ndarray,
    num_disp: int,
    min_disp: int,
    max_diff: int,
) -> jnp.ndarray:
    """Left-right consistency (disp12MaxDiff), OpenCV winner-scatter parity.

    OpenCV builds disp2 by scatter-min of each left pixel's *winning* cost
    into its right partner column. The gather dual: for right pixel xr,
    candidates are left pixels x = xr + min_disp + d whose WTA winner is d;
    take the one with the smallest winning cost. A left pixel is then
    invalidated only if both floor and ceil of its subpixel disparity point
    at valid right partners that disagree by more than max_diff.

    Operates on the (H, Wc) winner maps (best in [0, D), minS = winning
    cost), so it never touches the aggregated volume."""
    H, Wc = best.shape  # maps cover cropped columns [x0, x0 + Wc)
    D = num_disp
    x0 = min_disp + D  # OpenCV's minX1 for min_disp >= 0
    W_full = x0 + Wc
    BIG = jnp.int32(1 << 29)
    best = best.astype(jnp.int32)
    minS = minS.astype(jnp.int32)

    # Winner-only right-view cost, via static shifted slices.
    # Full-width frame: column x of `best`/`minS` lives at x0 + x.
    pad_best = jnp.pad(best, ((0, 0), (x0, D + min_disp)), constant_values=-1)
    pad_minS = jnp.pad(minS, ((0, 0), (x0, D + min_disp)), constant_values=BIG)

    # Running min/argmin over d: never materializes the (H, Wf, D) volume
    # (a stacked version costs two extra full-volume memory passes).
    run_min = jnp.full((H, W_full), BIG)
    run_arg = jnp.zeros((H, W_full), jnp.int32)
    for d in range(D):
        s = min_disp + d  # left partner offset
        b = jax.lax.slice_in_dim(pad_best, s, s + W_full, axis=1)
        v = jnp.where(
            b == d, jax.lax.slice_in_dim(pad_minS, s, s + W_full, axis=1), BIG
        )
        take = v < run_min
        run_min = jnp.where(take, v, run_min)
        run_arg = jnp.where(take, d, run_arg)
    has_partner = run_min < BIG
    dispR = run_arg + min_disp  # integer disparity units

    def check(d_int):
        """True where the partner at x - d_int confirms disparity d_int."""
        xr = (jnp.arange(Wc) + x0)[None, :] - d_int
        xr_c = jnp.clip(xr, 0, W_full - 1)
        partner_valid = jnp.take_along_axis(has_partner, xr_c, axis=1)
        dR = jnp.take_along_axis(dispR, xr_c, axis=1)
        in_img = (xr >= 0) & (xr < W_full)
        agree = jnp.abs(dR - d_int) <= max_diff
        # Off-image or invalid partner -> the check passes (cv2 keeps it).
        return ~(in_img & partner_valid) | agree

    d_floor = jnp.floor(disp).astype(jnp.int32)
    d_ceil = jnp.ceil(disp).astype(jnp.int32)
    # cv2 invalidates only if BOTH the floor and ceil checks fail.
    return check(d_floor) | check(d_ceil)


def speckle_filter_exact(
    disp: jnp.ndarray,
    valid: jnp.ndarray,
    max_speckle_size: int = 100,
    max_diff: float = 32.0,
) -> jnp.ndarray:
    """Exact cv2.filterSpeckles parity under jit: lowers the union-find
    connected-component filter (native/speckle.cc, pure-Python fallback)
    through jax.pure_callback. 100% mask agreement with OpenCV (tested on
    d2 and 4K frames); costs one host round-trip of two (H, W) maps.
    `sgbm_disparity_host_speckle` applies the same filter as a host
    post-pass when the maps are fetched anyway."""
    import numpy as np

    from stereo_reconstruction_cv_tpu import native

    def host(d, v):
        return native.filter_speckles(
            np.asarray(d), np.asarray(v), int(max_speckle_size), float(max_diff)
        )

    return jax.pure_callback(
        host,
        jax.ShapeDtypeStruct(disp.shape, jnp.bool_),
        disp.astype(jnp.float32),
        valid,
        vmap_method="sequential",
    )


def _seg_min_flood(lab: jnp.ndarray, conn: jnp.ndarray, axis: int,
                   big: jnp.ndarray) -> jnp.ndarray:
    """Two-sided min-flood of labels along `axis` within connectivity
    segments, by log-doubling: at level k every pixel takes the min of the
    pixels 2^k before/after it whenever the whole 2^k span is connected
    (span flags C_k compose as C_{k+1}[i] = C_k[i] & C_k[i - 2^k]).

    conn[i] = True means element i is connected to its predecessor along
    the axis (first slice False). ceil(log2(n)) levels of static pad-shift
    elementwise ops: no gathers, and a flat graph that compiles fast."""

    def shift_after(x, s, fill):
        """x[i + s] (values coming from later indices), static pad."""
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, s)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(s, None)
        return jnp.pad(x[tuple(sl)], pad, constant_values=fill)

    def shift_before(x, s, fill):
        """x[i - s] (values coming from earlier indices), static pad."""
        pad = [(0, 0)] * x.ndim
        pad[axis] = (s, 0)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(None, -s)
        return jnp.pad(x[tuple(sl)], pad, constant_values=fill)

    n = lab.shape[axis]
    C = conn
    s = 1
    while s < n:
        lab = jnp.minimum(lab, jnp.where(C, shift_before(lab, s, 0), big))
        C_next = shift_after(C, s, False)  # span (i .. i+s) connected
        lab = jnp.minimum(lab, jnp.where(C_next, shift_after(lab, s, 0), big))
        C = C & shift_before(C, s, False)
        s *= 2
    return lab


def speckle_filter(
    disp: jnp.ndarray,
    valid: jnp.ndarray,
    max_speckle_size: int = 100,
    max_diff: float = 32.0,
    max_rounds: int = 64,
) -> jnp.ndarray:
    """Remove small connected components of similar disparity
    (cv2.filterSpeckles semantics: 4-connectivity, |d(p)-d(q)| <= max_diff,
    regions smaller than max_speckle_size invalidated).

    Connected components via segmented min-floods iterated to convergence:
    each pixel starts as its own label (linear index); one round floods
    min-labels along full rows then full columns within connectivity
    segments (_seg_min_flood: log-doubling pad-shifts, no gathers).
    The lax.while_loop exits as soon as a round changes nothing, at which
    point every component carries exactly its global min label, so the
    result is EXACT (100% cv2.filterSpeckles mask agreement, tested on d2
    and 4K frames). A round resolves one horizontal-vertical alternation,
    so `max_rounds` bounds the worst-case staircase (a 64-turn component
    under the 100 px size cap does not occur in practice; adversarial
    percolation noise needs ~40)."""
    H, W = disp.shape
    lab0 = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    lab0 = jnp.where(valid, lab0, jnp.int32(H * W))  # invalid: shared sink
    big = jnp.int32(H * W)

    conn_r = (jnp.abs(disp[:, 1:] - disp[:, :-1]) <= max_diff) & valid[:, 1:] & valid[:, :-1]
    conn_d = (jnp.abs(disp[1:, :] - disp[:-1, :]) <= max_diff) & valid[1:, :] & valid[:-1, :]
    ch = jnp.concatenate([jnp.zeros((H, 1), bool), conn_r], axis=1)
    cv = jnp.concatenate([jnp.zeros((1, W), bool), conn_d], axis=0)

    def one_round(lab):
        new = _seg_min_flood(lab, ch, axis=1, big=big)
        new = _seg_min_flood(new, cv, axis=0, big=big)
        return new, jnp.any(new != lab)

    def cond(state):
        _, changed, i = state
        return changed & (i < max_rounds)

    def body(state):
        lab, _, i = state
        new, changed = one_round(lab)
        return new, changed, i + 1

    lab0r, chg0 = one_round(lab0)
    lab, _, _ = jax.lax.while_loop(cond, body, (lab0r, chg0, jnp.int32(1)))
    sizes = jnp.zeros(H * W + 1, jnp.int32).at[lab.reshape(-1)].add(1)
    return valid & (sizes[lab] > max_speckle_size)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def sgbm_cost_volume(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SGBMConfig
) -> jnp.ndarray:
    """Block-summed BT cost of the columns x >= minX1: (H, Wc, D) int16.

    OpenCV's prefilter pins the first/last column of every cost plane
    (sobel AND raw) to pre_filter_cap (stereosgbm calcPixelCostBT
    memset)."""
    cap = cfg.pre_filter_cap
    x0 = cfg.min_disparity + cfg.num_disparities  # OpenCV minX1 (min_disp>=0)
    capv = jnp.int32(cap)
    planes = []
    for p in (xsobel_clip(left, cap), xsobel_clip(right, cap),
              left.astype(jnp.int32), right.astype(jnp.int32)):
        planes.append(p.at[:, 0].set(capv).at[:, -1].set(capv))
    sl, sr, rawl, rawr = planes
    C = bt_cost_volume(sl, sr, rawl, rawr, cfg.num_disparities, cfg.min_disparity)
    return block_sum(C[:, x0:, :], cfg.block_size)


def sgbm_disparity_with(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SGBMConfig, aggregate
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """`sgbm_disparity` with the path aggregation `aggregate(C, cfg) -> S`
    supplied by the caller (unjitted; the kernel-vs-reference comparisons
    pass the XLA scans here)."""
    cap = cfg.pre_filter_cap
    # The cost volume is stored as int16: the block sum of per-pixel costs
    # (<= 2*cap + (255 >> 2)) must fit. cv2's own envelope is cap <= 63.
    if not (0 < cap and cfg.block_size ** 2 * (2 * cap + 63) <= 32767):
        raise ValueError(
            f"pre_filter_cap={cap} out of range for block_size="
            f"{cfg.block_size}: block_size^2 * (2*cap + 63) must be <= 32767 "
            "(int16 block sums; the reference uses 63, main.ipynb cell 10)"
        )
    x0 = cfg.min_disparity + cfg.num_disparities  # OpenCV minX1 (min_disp>=0)
    with jax.named_scope("sgbm_cost"):
        C = sgbm_cost_volume(left, right, cfg)
    with jax.named_scope("sgbm_aggregate"):
        S = aggregate(C, cfg)
    with jax.named_scope("sgbm_wta"):
        disp, valid = wta_disparity(S, cfg.min_disparity, cfg.uniqueness_ratio)
    if cfg.disp12_max_diff >= 0:
        with jax.named_scope("sgbm_lr_check"):
            valid &= lr_check(S, disp, cfg.min_disparity, cfg.disp12_max_diff)
    # Pad the invalid left margin back to full width.
    disp = jnp.pad(disp, ((0, 0), (x0, 0)), constant_values=float(cfg.min_disparity - 1))
    valid = jnp.pad(valid, ((0, 0), (x0, 0)), constant_values=False)
    if cfg.speckle_window_size > 0:
        with jax.named_scope("sgbm_speckle"):
            valid = _speckle(disp, valid, cfg)
    return disp, valid


@functools.partial(jax.jit, static_argnames=("cfg",))
def sgbm_disparity(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SGBMConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full SGBM: grayscale (H, W) uint8 pair -> (float disparity, valid).

    Float output equals cv2's int16 /16.0 convention (reference cell 10
    divides by 16 and zeroes non-positive pixels — use
    compute_disparity_map for that exact wrapper).

    Column handling mirrors OpenCV: disparities are computed only for
    x >= min_disparity + num_disparities (minX1); the left margin is
    invalid, and window/path aggregation replicates at that cropped
    boundary, not at the true image edge."""
    return sgbm_disparity_with(left, right, cfg, sgm_aggregate_auto)


def _speckle(disp: jnp.ndarray, valid: jnp.ndarray, cfg: SGBMConfig) -> jnp.ndarray:
    if cfg.speckle_backend == "exact":
        return speckle_filter_exact(
            disp, valid, cfg.speckle_window_size, float(cfg.speckle_range)
        )
    # The left margin x < minX1 is invalid by construction (OpenCV column
    # cropping), so no component reaches into it — slice it off before
    # the flood and pad the (masked-anyway) margin back as not-kept.
    x0 = cfg.min_disparity + cfg.num_disparities
    keep = speckle_filter(
        disp[:, x0:], valid[:, x0:],
        cfg.speckle_window_size, float(cfg.speckle_range),
    )
    return jnp.pad(keep, ((0, 0), (x0, 0)), constant_values=False)


def _device_bytes_free() -> int | None:
    """Free bytes of the default device, or None where the device reports
    no limit (the CPU: host memory, no tiling needed)."""
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))


@functools.lru_cache(maxsize=None)
def whole_frame_bytes_per_cell(H: int, W: int, cfg: SGBMConfig) -> float:
    """Device bytes one whole-frame `sgbm_disparity` needs per cost-volume
    cell, from the compiler's own memory analysis of that program
    (arguments + outputs + temporaries, less donated aliases)."""
    spec = jax.ShapeDtypeStruct((H, W), jnp.uint8)
    ma = sgbm_disparity.lower(spec, spec, cfg).compile().memory_analysis()
    total = (ma.argument_size_in_bytes + ma.output_size_in_bytes
             + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    cells = H * (W - cfg.min_disparity - cfg.num_disparities) * cfg.num_disparities
    return total / max(cells, 1)


def fits_whole_frame(H: int, W: int, cfg: SGBMConfig) -> bool:
    """Whether one frame's SGBM fits the device without row tiling.

    The compiler's plan is compared with the free bytes as it stands: at
    4K x 256 x 5 on an H100 the device's measured peak over the whole
    frame was the plan plus 0.02 GB of other live arrays (PERF.md)."""
    free = _device_bytes_free()
    if free is None:
        return True
    cells = H * (W - cfg.min_disparity - cfg.num_disparities) * cfg.num_disparities
    need = whole_frame_bytes_per_cell(H, W, cfg) * cells
    return need <= free


def sgbm_disparity_auto(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SGBMConfig, tile_rows: int = 512
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """sgbm_disparity, row-tiled only when the frame cannot fit the device."""
    H, W = left.shape
    if fits_whole_frame(H, W, cfg):
        return sgbm_disparity(left, right, cfg)
    return sgbm_disparity_tiled(left, right, cfg, tile_rows=tile_rows)


# ---------------------------------------------------------------------------
# Coarse-to-fine fast path
# ---------------------------------------------------------------------------

def _box2(img: jnp.ndarray) -> jnp.ndarray:
    """2x box downsample of a (H, W) uint8 image (OpenCV INTER_AREA
    semantics for factor 2: mean of each 2x2 block, rounded)."""
    H, W = img.shape
    a = img[: H - H % 2, : W - W % 2].astype(jnp.int32)
    s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
    return ((s + 2) >> 2).astype(jnp.uint8)


def _shift_plane(a: jnp.ndarray, s: int) -> jnp.ndarray:
    """a[y, x - s] with edge replication (static shift)."""
    if s == 0:
        return a
    if s > 0:
        return jnp.concatenate(
            [jnp.repeat(a[:, :1], s, axis=1), a[:, :-s]], axis=1)
    return jnp.concatenate(
        [a[:, -s:], jnp.repeat(a[:, -1:], -s, axis=1)], axis=1)


def _warp_by_disp(planes: Sequence[jnp.ndarray], d0: jnp.ndarray,
                  num_disp: int) -> list:
    """planes[k][y, x - d0[y, x]] for integer d0 in [0, num_disp), as a
    static shift + select chain that XLA fuses into one elementwise pass."""
    outs = [jnp.zeros_like(p) for p in planes]
    for s in range(num_disp):
        hit = d0 == s
        outs = [jnp.where(hit, _shift_plane(p, s), o)
                for p, o in zip(planes, outs)]
    return outs


def sgbm_disparity_fast(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: SGBMConfig,
    refine_radius: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Coarse-to-fine SGBM: full-range SGM at half resolution, then a
    full-resolution refinement over +-refine_radius disparities around
    the upsampled coarse map.

    The production fast path (libSGM-style multi-scale): the coarse level
    runs the exact pipeline on a 2x box-downsampled pair with D/2
    disparities (1/8 the cells); the fine level warps the right-image
    cost planes by the integer coarse disparity (static shift+select
    chain, no gathers) and re-scores the 2*r+1 candidate disparities with
    the exact BT + 11x11 block cost, WTA + quadratic subpixel. Validity
    (uniqueness + L-R + speckle) comes from the coarse level, upsampled;
    the speckle filter reruns at full resolution on the refined map.

    Accuracy is gate-tested against full-range cv2.StereoSGBM on the
    bundled real pairs (tests/test_disparity.py::test_fast_mode_gate):
    the refined map stays within 1 px of cv2 on >= 95% of the pixels both
    declare valid, the same bar BASELINE.json sets for the exact path."""
    H, W = left.shape
    D = cfg.num_disparities
    r = refine_radius
    # ---- coarse: exact pipeline at half resolution, half range ----
    cfg_h = cfg.with_(
        num_disparities=max(16, D // 2),
        min_disparity=cfg.min_disparity // 2,
        speckle_window_size=0,
    )
    lh, rh = _box2(left), _box2(right)
    d_h, v_h = sgbm_disparity(lh, rh, cfg_h)
    # ---- upsample: nearest x2, disparities doubled ----
    d0f = jnp.repeat(jnp.repeat(d_h * 2.0, 2, axis=0), 2, axis=1)[:H, :W]
    v0 = jnp.repeat(jnp.repeat(v_h, 2, axis=0), 2, axis=1)[:H, :W]
    Hh2, Wh2 = 2 * d_h.shape[0], 2 * d_h.shape[1]
    if Hh2 < H or Wh2 < W:  # odd full-res edge rows/cols
        d0f = jnp.pad(d0f, ((0, H - min(H, Hh2)), (0, W - min(W, Wh2))),
                      mode="edge")
        v0 = jnp.pad(v0, ((0, H - min(H, Hh2)), (0, W - min(W, Wh2))),
                     mode="edge")
    d0 = jnp.clip(jnp.round(d0f), cfg.min_disparity, cfg.min_disparity + D - 1
                  ).astype(jnp.int32)
    # ---- fine: re-score d0 + k, k in [-r, r], exact BT + block cost ----
    cap = cfg.pre_filter_cap
    sl = xsobel_clip(left, cap)
    sr = xsobel_clip(right, cap)
    rawl, rawr = left.astype(jnp.int32), right.astype(jnp.int32)
    wsr, wraw = _warp_by_disp((sr, rawr), d0, cfg.min_disparity + D)

    def bt_pair(a, b):
        """Symmetric BT between aligned planes at integer alignment; the
        half-pixel range terms use the warped plane's own neighbors."""
        blo, bhi = _halfpixel_range(b)
        alo, ahi = _halfpixel_range(a)
        c0 = jnp.maximum(jnp.maximum(a - bhi, blo - a), 0)
        c1 = jnp.maximum(jnp.maximum(b - ahi, alo - b), 0)
        return jnp.minimum(c0, c1)

    costs = []
    for k in range(-r, r + 1):
        cs = bt_pair(sl, _shift_plane(wsr, k))
        craw = bt_pair(rawl, _shift_plane(wraw, k))
        costs.append(cs + (craw >> 2))
    Ck = jnp.stack(costs, axis=-1)  # (H, W, 2r+1) int32
    Ck = block_sum(Ck, cfg.block_size)
    best_k = jnp.argmin(Ck, axis=-1)
    minC = jnp.min(Ck, axis=-1)
    kidx = jax.lax.broadcasted_iota(jnp.int32, Ck.shape, 2)
    km1 = jnp.clip(best_k - 1, 0, 2 * r)
    kp1 = jnp.clip(best_k + 1, 0, 2 * r)
    Cm1 = jnp.sum(jnp.where(kidx == km1[..., None], Ck, 0), axis=-1)
    Cp1 = jnp.sum(jnp.where(kidx == kp1[..., None], Ck, 0), axis=-1)
    denom = jnp.maximum(Cm1 + Cp1 - 2 * minC, 1).astype(jnp.float32)
    frac = (Cm1 - Cp1).astype(jnp.float32) / (2.0 * denom)
    interior = (best_k > 0) & (best_k < 2 * r)
    disp = (d0 + best_k - r).astype(jnp.float32) + jnp.where(interior, frac, 0.0)
    lo = float(cfg.min_disparity)
    disp = jnp.clip(disp, lo, lo + D - 1)
    valid = v0
    if cfg.speckle_window_size > 0:
        valid = _speckle(disp, valid, cfg)
    return disp, valid


def sgbm_disparity_tiled(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: SGBMConfig,
    tile_rows: int = 512,
    halo: int = 32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SGBM for frames whose cost volume exceeds device memory: process row
    tiles with a
    `halo`-row warm-start overlap (same scheme as the multi-chip row
    sharding, parallel/sgm_sharded.py) and stitch; the speckle filter runs
    globally afterwards. Peak memory scales with tile_rows, not H."""
    H, W = left.shape
    if H <= tile_rows:
        return sgbm_disparity(left, right, cfg)
    core = cfg.with_(speckle_window_size=0)
    disp_parts, valid_parts = [], []
    for y0 in range(0, H, tile_rows):
        y1 = min(y0 + tile_rows, H)
        a = max(y0 - halo, 0)
        b = min(y1 + halo, H)
        d, v = sgbm_disparity(left[a:b], right[a:b], core)
        disp_parts.append(d[y0 - a : y0 - a + (y1 - y0)])
        valid_parts.append(v[y0 - a : y0 - a + (y1 - y0)])
    disp = jnp.concatenate(disp_parts, axis=0)
    valid = jnp.concatenate(valid_parts, axis=0)
    if cfg.speckle_window_size > 0:
        valid = _speckle(disp, valid, cfg)
    return disp, valid


def sgbm_disparity_host_speckle(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SGBMConfig
):
    """SGBM with the exact union-find speckle filter applied host-side.

    The device computes everything up to (and excluding) the speckle pass;
    the fetched maps get the exact cv2.filterSpeckles-parity filter
    (native/speckle.cc). Use when the maps are coming to host anyway (PLY
    export, visualization). Returns numpy (disp, valid)."""
    import numpy as np

    from stereo_reconstruction_cv_tpu import native

    core = cfg.with_(speckle_window_size=0)
    disp, valid = sgbm_disparity_auto(left, right, core)
    disp = np.asarray(disp)
    valid = np.asarray(valid)
    if cfg.speckle_window_size > 0:
        valid = native.filter_speckles(
            disp, valid, cfg.speckle_window_size, float(cfg.speckle_range)
        )
    return disp, valid


def compute_disparity_map(
    imgL: jnp.ndarray, imgR: jnp.ndarray, ndisp: int = 16, mindis: int = 0,
    speckle_backend: str = "exact",
) -> jnp.ndarray:
    """Reference-parity wrapper (main.ipynb cell 10): StereoSGBM with the
    notebook's exact parameters, /16 float output, non-positive zeroed.

    speckle_backend='exact' (default) applies the union-find filter on the
    host after the device pipeline — exact cv2 semantics, and free in this
    wrapper since the result is fetched anyway. 'propagate' keeps the
    whole pipeline on device."""
    cfg = SGBMConfig(min_disparity=mindis, num_disparities=ndisp, num_directions=5)
    if imgL.ndim == 3:  # reference feeds BGR; SGBM cost uses the gray plane
        imgL = rgb_to_gray_u8(imgL)
        imgR = rgb_to_gray_u8(imgR)
    if speckle_backend == "exact":
        disp, valid = sgbm_disparity_host_speckle(imgL, imgR, cfg)
        disp = jnp.asarray(disp)
        valid = jnp.asarray(valid)
    else:
        disp, valid = sgbm_disparity_auto(imgL, imgR, cfg)
    disp = jnp.where(valid, disp, float(mindis) - 1.0)
    return jnp.where(disp > 0, disp, 0.0)


def rgb_to_gray_u8(img: jnp.ndarray) -> jnp.ndarray:
    """BT.601 luma, OpenCV cvtColor rounding (assumes RGB channel order)."""
    r = img[..., 0].astype(jnp.float32)
    g = img[..., 1].astype(jnp.float32)
    b = img[..., 2].astype(jnp.float32)
    return jnp.round(0.299 * r + 0.587 * g + 0.114 * b).astype(jnp.uint8)
