"""Fixed-budget batched robust estimation (RANSAC / LMedS), batched on the device.

Replaces cv2.findFundamentalMat(FM_LMEDS) (gui.py:135) and
cv2.findEssentialMat(RANSAC, prob=0.999, thr=1.0) (gui.py:142). Instead of
the sequential hypothesize-and-verify loop OpenCV runs, all M hypotheses are
drawn, solved, and scored simultaneously:

    sample (M, k) indices -> vmapped minimal solver -> (M, 3, 3) models
    -> residual matrix (M, N) in one shot -> argmin/argmax score.

Static shapes throughout: points come in fixed-size arrays with a validity
mask (the matcher's output convention), so the whole engine jits once and
runs for any true correspondence count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.ops import epipolar as EP
from stereo_reconstruction_cv_tpu.ops import geometry as G


class RobustResult(NamedTuple):
    model: jnp.ndarray          # (3, 3) best model (refit on inliers)
    inlier_mask: jnp.ndarray    # (N,) bool
    num_inliers: jnp.ndarray    # scalar int
    score: jnp.ndarray          # scalar: inlier count (ransac) / -median (lmeds)


def _sample_indices(key, num_points: int, mask: jnp.ndarray, num_hypotheses: int, k: int):
    """(M, k) distinct valid indices per hypothesis via the Gumbel top-k
    trick: random keys, invalid entries at -inf, take the k largest."""
    gumbel = jax.random.gumbel(key, (num_hypotheses, num_points))
    gumbel = jnp.where(mask[None, :], gumbel, -jnp.inf)
    _, idx = jax.lax.top_k(gumbel, k)
    return idx


def _masked_median(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over valid entries only; invalid sorted to +inf. (M, N) -> (M,)."""
    n_valid = jnp.sum(mask)
    v = jnp.where(mask[None, :], values, jnp.inf)
    v = jnp.sort(v, axis=-1)
    mid = jnp.maximum(n_valid - 1, 0) // 2
    hi_idx = jnp.maximum(jnp.minimum(mid + (1 - n_valid % 2), n_valid - 1), 0)
    lo = jnp.take_along_axis(v, jnp.full((v.shape[0], 1), mid), axis=-1)[:, 0]
    hi = jnp.take_along_axis(v, jnp.full((v.shape[0], 1), hi_idx), axis=-1)[:, 0]
    med = 0.5 * (lo + hi)
    # n_valid == 0 would otherwise index -1 (wraparound garbage); surface
    # the degenerate case as +inf so callers can detect it.
    return jnp.where(n_valid > 0, med, jnp.inf)


def robust_fit(
    key: jax.Array,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray,
    solver: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    residual_fn: Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], jnp.ndarray],
    refit: Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], jnp.ndarray],
    method: str = "ransac",
    num_hypotheses: int = 512,
    sample_size: int = 8,
    threshold: float = 1.0,
    lo_iters: int = 2,
    tiebreak_fn: Callable | None = None,
) -> RobustResult:
    """Generic fixed-budget robust model fit.

    solver(p1 (k,2), p2 (k,2)) -> model, or (models (nm,3,3), valid (nm,))
    for multi-root minimal solvers; residual_fn(model, pts1, pts2) ->
    squared residual (N,); refit(pts1, pts2, weights) -> model.
    method: 'ransac' (count inliers under threshold^2) or 'lmeds'
    (minimize median squared residual; inliers by the 2.5-sigma MAD rule
    OpenCV uses in its LMedS implementation). tiebreak_fn(model, pts1,
    pts2, mask) -> [0, 1) adds a fractional ranking bonus under 'ransac'.
    """
    num_points = pts1.shape[0]
    idx = _sample_indices(key, num_points, mask, num_hypotheses, sample_size)
    s1 = pts1[idx]  # (M, k, 2)
    s2 = pts2[idx]
    out = jax.vmap(solver)(s1, s2)
    if isinstance(out, tuple):
        # Multi-model minimal solver (e.g. 5-point: <= 10 roots/sample):
        # every candidate of every sample is an independent hypothesis.
        models, model_ok = out
        models = models.reshape(-1, 3, 3)
        model_ok = model_ok.reshape(-1)
    else:
        models = out  # (M, 3, 3)
        model_ok = jnp.ones(models.shape[0], bool)
    residuals = jax.vmap(lambda m: residual_fn(m, pts1, pts2))(models)  # (M, N)
    residuals = jnp.nan_to_num(residuals, nan=jnp.inf, posinf=jnp.inf)
    residuals = jnp.where(model_ok[:, None], residuals, jnp.inf)

    thr2 = jnp.asarray(threshold, residuals.dtype) ** 2
    if method == "ransac":
        inlier = (residuals < thr2) & mask[None, :]
        score = jnp.sum(inlier, axis=-1).astype(residuals.dtype)
        if tiebreak_fn is not None:
            # Fractional bonus in [0, 1): orders models with equal inlier
            # counts (e.g. cheirality among the planar-degenerate E family)
            # without ever outvoting an extra inlier. Evaluated ONLY for
            # the top-K models by inlier count: the bonus can never lift a
            # model past one extra inlier, so anything below the K-th
            # count can't win anyway — and evaluating it for all M*10
            # multi-root candidates materializes (M*10, N, 3) pose-depth
            # temporaries (gigabytes at M=1024, N=4096; observed minutes
            # of wall time on the CPU test tier).
            K = min(32, models.shape[0])
            top_s, top_i = jax.lax.top_k(score, K)
            bonus = jax.vmap(
                lambda m: tiebreak_fn(m, pts1, pts2, mask)
            )(models[top_i])
            # Ignore bonuses for models strictly below the best count.
            bonus = jnp.where(top_s >= top_s[0], bonus, 0.0)
            best = top_i[jnp.argmax(top_s + bonus)]
            score = score.at[top_i].add(bonus)
        else:
            best = jnp.argmax(score)
        best_inliers = inlier[best]
        best_score = score[best].astype(residuals.dtype)
    elif method == "lmeds":
        med = _masked_median(residuals, mask)
        best = jnp.argmin(med)
        n_valid = jnp.sum(mask)
        # OpenCV's robust scale: sigma = 2.5 * 1.4826 * (1 + 5/(n-k)) * sqrt(med)
        sigma = (
            2.5
            * 1.4826
            * (1.0 + 5.0 / jnp.maximum(n_valid - sample_size, 1))
            * jnp.sqrt(jnp.maximum(med[best], 0.0))
        )
        best_inliers = (residuals[best] < jnp.maximum(sigma, 1e-12) ** 2) & mask
        best_score = -med[best]
    else:
        raise ValueError(f"unknown method {method!r}")

    # Local optimization: refit on inliers, re-threshold, repeat (LO-RANSAC
    # style, fixed iteration count for jit). The threshold for re-selection
    # comes from the method's own inlier rule.
    if method == "ransac":
        sel_thr2 = thr2
    else:
        n_valid = jnp.sum(mask)
        med_best = -best_score
        sigma = (
            2.5 * 1.4826 * (1.0 + 5.0 / jnp.maximum(n_valid - sample_size, 1))
            * jnp.sqrt(jnp.maximum(med_best, 0.0))
        )
        sel_thr2 = jnp.maximum(sigma, 1e-12) ** 2

    inliers = best_inliers
    model = models[best]
    for _ in range(1 + lo_iters):
        w = inliers.astype(pts1.dtype)
        refit_model = refit(pts1, pts2, w)
        # Keep the refit only if it doesn't lose inliers (guards degeneracy).
        res_new = jnp.nan_to_num(
            residual_fn(refit_model, pts1, pts2), nan=jnp.inf, posinf=jnp.inf
        )
        inl_new = (res_new < sel_thr2) & mask
        n_new = jnp.sum(inl_new).astype(pts1.dtype)
        n_old = jnp.sum(inliers).astype(pts1.dtype)
        if tiebreak_fn is not None:
            # With a tiebreak, an equal-inlier refit must also rank at
            # least as high (e.g. a planar-degenerate 8-point refit ties
            # on inliers but loses the cheirality vote).
            n_new = n_new + tiebreak_fn(refit_model, pts1, pts2, mask)
            n_old = n_old + tiebreak_fn(model, pts1, pts2, mask)
        better = (n_new >= n_old) & (jnp.sum(inliers) >= sample_size)
        model = jnp.where(better, refit_model, model)
        inliers = jnp.where(better, inl_new, inliers)
    return RobustResult(model, inliers, jnp.sum(inliers), best_score)


def cheirality_fraction(
    E: jnp.ndarray, npts1: jnp.ndarray, npts2: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Fraction of correspondences with positive depth in both views under
    the best of E's four pose decompositions, scaled into [0, 1).

    Closed-form two-view depths (no triangulation solve): from
    z2 x2 = z1 R x1 + t, crossing with x2 gives
    z1 = -(x2 x t)·(x2 x R x1) / |x2 x R x1|^2.

    Used as the RANSAC tiebreak for E: on (near-)planar scenes a whole
    family of essential matrices fits the epipolar constraint equally well
    (x2 ~ H x1 makes x2^T [v]x H x1 = 0 for EVERY v), so inlier counts
    tie; only the true member reconstructs points in front of both
    cameras. cv2's USAC path applies the same degeneracy guard."""
    R1, R2, t = EP.decompose_essential(E)
    ones = jnp.ones_like(npts1[..., :1])
    x1 = jnp.concatenate([npts1, ones], axis=-1)
    x2 = jnp.concatenate([npts2, ones], axis=-1)
    msum = jnp.sum(mask) + 1e-30

    def frac(R, tt):
        Rx1 = x1 @ R.T
        c1 = jnp.cross(x2, Rx1)
        c2 = jnp.cross(x2, jnp.broadcast_to(tt, x2.shape))
        z1 = -jnp.sum(c2 * c1, -1) / (jnp.sum(c1 * c1, -1) + 1e-30)
        z2 = z1 * Rx1[:, 2] + tt[2]
        ok = (z1 > 0) & (z2 > 0) & mask
        return jnp.sum(ok) / msum

    fr = jnp.stack([frac(R1, t), frac(R1, -t), frac(R2, t), frac(R2, -t)])
    return 0.999 * jnp.max(fr)


# ---------------------------------------------------------------------------
# Instances: F via LMedS / RANSAC, E via RANSAC  (reference parameter sets)
# ---------------------------------------------------------------------------

def find_fundamental(
    key: jax.Array,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    method: str = "lmeds",
    num_hypotheses: int = 512,
    threshold: float = 1.0,
) -> RobustResult:
    """Robust F. Default LMedS matches the reference (gui.py:135 FM_LMEDS).

    Residual: Sampson distance in pixels (squared)."""
    if mask is None:
        mask = jnp.ones(pts1.shape[0], bool)

    def solver(p1, p2):
        return EP.eight_point(p1, p2)

    def residual(Fm, p1, p2):
        return G.sampson_error(Fm, p1, p2)

    def refit(p1, p2, w):
        return EP.eight_point(p1, p2, weights=w)

    return robust_fit(
        key, pts1, pts2, mask, solver, residual, refit,
        method=method, num_hypotheses=num_hypotheses, sample_size=8,
        threshold=threshold,
    )


def find_essential(
    key: jax.Array,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    K: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    threshold_px: float = 1.0,
    num_hypotheses: int = 512,
    solver: str = "5pt",
) -> RobustResult:
    """Robust E via batched RANSAC on K-normalized coords.

    Matches the reference call cv2.findEssentialMat(..., RANSAC, 0.999, 1.0)
    (gui.py:142), including the minimal solver: cv2 runs Nistér's 5-point,
    and the default here is the batched 5-point (ops/fivepoint.py; every
    real root of every sample scores as an independent hypothesis — a
    5-point sample yields <= 10). The pixel threshold is divided by the
    mean focal length, exactly as OpenCV does internally. solver='8pt'
    selects the round-1 normalized-8-point fallback (degenerate for planar
    scenes). The local-optimization refit stays 8-point on the inlier set
    in both modes; the refit is only kept when it does not lose inliers,
    which guards the planar-degenerate refit case."""
    if mask is None:
        mask = jnp.ones(pts1.shape[0], bool)
    n1 = EP.pixel_to_normalized(pts1, K)
    n2 = EP.pixel_to_normalized(pts2, K)
    f_mean = 0.5 * (K[0, 0] + K[1, 1])
    thr = jnp.asarray(threshold_px, n1.dtype) / f_mean

    if solver == "5pt":
        from stereo_reconstruction_cv_tpu.ops.fivepoint import essential_5pt

        solve = essential_5pt
        sample_size = 5
        # Each 5-point sample yields up to 10 real roots, every one scored
        # as a hypothesis — num_hypotheses budgets CANDIDATES, so draw
        # ~num/8 samples (floor 64). Keeps residual/score work comparable
        # to the 8-point path instead of 10x it.
        num_hypotheses = max(64, num_hypotheses // 8)
    elif solver == "8pt":
        solve = lambda p1, p2: EP.essential_8pt(p1, p2)
        sample_size = 8
    else:
        raise ValueError(f"unknown essential solver {solver!r}")

    def residual(Em, p1, p2):
        return G.sampson_error(Em, p1, p2)

    def refit(p1, p2, w):
        return EP.essential_8pt(p1, p2, weights=w)

    return robust_fit(
        key, n1, n2, mask, solve, residual, refit,
        method="ransac", num_hypotheses=num_hypotheses,
        sample_size=sample_size, threshold=thr,
        tiebreak_fn=cheirality_fraction,
    )
