"""Descriptor matching: exact top-2 nearest neighbors by one matmul + ratio test.

Replaces cv2.FlannBasedMatcher.knnMatch(k=2) + the Python ratio-test loop
(reference gui.py:117-131, 211-241). FLANN is an *approximate* KD-tree search
tuned for CPUs; on an accelerator one dense distance matmul is both faster and exact
(exact ⊇ approximate), and deterministic.

Static-shape convention: descriptor arrays are padded to a fixed capacity
with a validity mask; outputs are fixed-size index/mask arrays. This is the
calling convention every downstream stage (robust F/E, triangulation) uses.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class MatchResult(NamedTuple):
    indices: jnp.ndarray    # (N,) int32: best match in desc2 for each desc1
    distance: jnp.ndarray   # (N,) best match distance
    second: jnp.ndarray     # (N,) second-best distance
    mask: jnp.ndarray       # (N,) bool: valid AND passed the ratio test


def squared_distance_matrix(
    d1: jnp.ndarray, d2: jnp.ndarray, valid2: jnp.ndarray | None = None
) -> jnp.ndarray:
    """(N, D), (M, D) -> (N, M) squared L2 distances via one matmul.

    ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b — the inner product term is a
    single matmul; run in f32 accumulation regardless of input dtype.
    """
    n1 = jnp.sum(d1.astype(jnp.float32) ** 2, axis=-1, keepdims=True)
    n2 = jnp.sum(d2.astype(jnp.float32) ** 2, axis=-1, keepdims=True)
    cross = jnp.dot(d1, d2.T, preferred_element_type=jnp.float32)
    dist = n1 + n2.T - 2.0 * cross
    dist = jnp.maximum(dist, 0.0)
    if valid2 is not None:
        dist = jnp.where(valid2[None, :], dist, jnp.inf)
    return dist


def knn2_match(
    d1: jnp.ndarray,
    d2: jnp.ndarray,
    valid1: jnp.ndarray | None = None,
    valid2: jnp.ndarray | None = None,
    ratio: float = 0.7,
    mutual: bool = False,
) -> MatchResult:
    """Exact k=2 NN with Lowe ratio test.

    ratio defaults to 0.7 (geometry path, gui.py:129); the inspection path
    uses 0.75 (gui.py:241). L2 on descriptors, matching cv2's SIFT+FLANN
    configuration. mutual=True adds a cross-check (not in the reference,
    but standard for learned descriptors such as XFeat)."""
    dist = squared_distance_matrix(d1, d2, valid2)
    # Top-2 smallest along axis 1 without a full sort.
    best_idx = jnp.argmin(dist, axis=-1)
    best = jnp.take_along_axis(dist, best_idx[:, None], axis=-1)[:, 0]
    dist2 = dist.at[jnp.arange(dist.shape[0]), best_idx].set(jnp.inf)
    second = jnp.min(dist2, axis=-1)
    # Lowe ratio on *distances* (cv2 DMatch.distance is the L2 norm, so
    # compare sqrt; squared form: best < ratio^2 * second).
    ok = best < (ratio * ratio) * second
    if valid1 is not None:
        ok &= valid1
    ok &= jnp.isfinite(best)
    if mutual:
        # Padded/invalid d1 rows must not steal backward matches.
        bdist = dist if valid1 is None else jnp.where(valid1[:, None], dist, jnp.inf)
        back = jnp.argmin(bdist, axis=0)  # best d1 for each d2
        ok &= back[best_idx] == jnp.arange(d1.shape[0])
    return MatchResult(best_idx.astype(jnp.int32), jnp.sqrt(best), jnp.sqrt(second), ok)


def match_learned(
    d1: jnp.ndarray,
    d2: jnp.ndarray,
    valid1: jnp.ndarray | None = None,
    valid2: jnp.ndarray | None = None,
    min_cossim: float = 0.5,
) -> MatchResult:
    """Mutual-NN + cosine-similarity matching for learned descriptors.

    Dense-grid learned descriptors (XFeat-style nets sample a 1/8-res
    descriptor field) have near-duplicate second neighbors — the adjacent
    grid cell — so Lowe's ratio test rejects almost everything. The
    upstream XFeat matcher (verlab/accelerated_features, the net the
    reference's Tab 7 wraps) therefore uses mutual nearest neighbors
    gated on min cosine similarity instead; same policy here. The gate is
    deliberately permissive (0.5): absolute similarity levels are
    scene-dependent (bundled d2 peaks near 0.8 with an 85% F-inlier rate
    at 0.5), and the robust estimators downstream reject outliers anyway.
    Descriptors are assumed L2-normalized, so cossim = 1 - dist^2 / 2."""
    dist = squared_distance_matrix(d1, d2, valid2)
    best_idx = jnp.argmin(dist, axis=-1)
    best = jnp.take_along_axis(dist, best_idx[:, None], axis=-1)[:, 0]
    dist2 = dist.at[jnp.arange(dist.shape[0]), best_idx].set(jnp.inf)
    second = jnp.min(dist2, axis=-1)
    cossim = 1.0 - 0.5 * best
    ok = cossim >= min_cossim
    if valid1 is not None:
        ok &= valid1
    ok &= jnp.isfinite(best)
    bdist = dist if valid1 is None else jnp.where(valid1[:, None], dist, jnp.inf)
    back = jnp.argmin(bdist, axis=0)
    ok &= back[best_idx] == jnp.arange(d1.shape[0])
    return MatchResult(best_idx.astype(jnp.int32), jnp.sqrt(best), jnp.sqrt(second), ok)


def gather_correspondences(
    kpts1: jnp.ndarray, kpts2: jnp.ndarray, match: MatchResult
):
    """Keypoints (N, 2), (M, 2) + match -> (pts1 (N, 2), pts2 (N, 2), mask).

    Fixed-size output: row i pairs kpts1[i] with kpts2[match.indices[i]];
    mask selects rows that passed the ratio test. Feed directly into
    robust.find_fundamental / find_essential."""
    return kpts1, kpts2[match.indices], match.mask
