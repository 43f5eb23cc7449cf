"""Small dense linear algebra without LAPACK-style lowerings.

jnp.linalg.{eigh, svd, inv, solve} lower to general iterative solvers
whose compile and run time far exceed what 3x3/4x4/9x9 problems need.
Everything here is closed-form or fixed-iteration,
fully unrolled, batched over leading dims, and compiles in seconds:

- inv3:            analytic adjugate / determinant
- chol / chol_solve: unrolled Cholesky for tiny SPD systems
- smallest_eigvec: inverse iteration (shift eps * mean-eig) — converges
                   quadratically-fast in the gap ratio (~3 iterations for
                   DLT normal matrices), far more robust than shifted
                   power iteration when the spectrum is spread
- svd3:            3x3 SVD via the analytic symmetric eigendecomposition
                   of A^T A (trigonometric Cardano + cross-product
                   eigenvectors, Eberly-style robust ordering)

Used by the epipolar/robust/triangulation stack so the whole sparse
geometry path runs on the device (SURVEY §2.3 rows findFundamentalMat,
findEssentialMat, recoverPose, triangulatePoints).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Analytic 3x3
# ---------------------------------------------------------------------------

def det3(A: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., 3, 3)."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Inverse of (..., 3, 3) via the adjugate."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c02 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c10 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c20 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c21 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c01 + A[..., 0, 2] * c02
    adjT = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return adjT / (det[..., None, None] + jnp.where(det[..., None, None] == 0, 1e-30, 0.0))


# ---------------------------------------------------------------------------
# Unrolled Cholesky + inverse iteration (any small n, static)
# ---------------------------------------------------------------------------

def chol(A: jnp.ndarray) -> jnp.ndarray:
    """Cholesky of SPD (..., n, n), fully unrolled (n static, small)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    rows = [
        jnp.stack([L[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0]) for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def chol_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given L = chol(A). b: (..., n)."""
    n = L.shape[-1]
    y = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y.append(s / L[..., i, i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def smallest_eigvec(A: jnp.ndarray, iters: int = 4, eps: float = 1e-6) -> jnp.ndarray:
    """Unit eigenvector for the smallest eigenvalue of symmetric PSD
    (..., n, n) via inverse iteration on A + eps*mean_eig*I.

    Each iteration multiplies the error by (lam_min + shift)/(lam_2 + shift);
    for DLT normal matrices (lam_min ~ 0, lam_2 >> shift) one iteration is
    already ~1e-6, so `iters`=4 is far below f32 noise. Degenerate spectra
    (lam_2 ~ lam_min) converge slowly but any vector of the bottom
    eigenspace is then equally valid for the consumers here (RANSAC
    hypotheses are scored, projections are basis-invariant)."""
    n = A.shape[-1]
    tr = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None]
    shift = eps * tr / n + 1e-30
    L = chol(A + shift * jnp.eye(n, dtype=A.dtype))
    v = jnp.full(A.shape[:-1], 1.0 / (n ** 0.5), A.dtype)
    # Deterministic tie-breaker so v is never exactly orthogonal to the
    # target across a whole batch.
    v = v + 1e-3 * jnp.arange(n, dtype=A.dtype) / n
    for _ in range(iters):
        v = chol_solve(L, v)
        v = v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)
    return v


# ---------------------------------------------------------------------------
# Analytic symmetric 3x3 eigendecomposition + 3x3 SVD (no LAPACK)
# ---------------------------------------------------------------------------

def eigvals3_sym(B: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric (..., 3, 3), ascending (trig Cardano)."""
    q = jnp.trace(B, axis1=-2, axis2=-1) / 3.0
    d0, d1, d2 = B[..., 0, 0] - q, B[..., 1, 1] - q, B[..., 2, 2] - q
    p1 = B[..., 0, 1] ** 2 + B[..., 0, 2] ** 2 + B[..., 1, 2] ** 2
    p2 = d0 ** 2 + d1 ** 2 + d2 ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-38))
    Bn = (B - q[..., None, None] * jnp.eye(3, dtype=B.dtype)) / p[..., None, None]
    r = jnp.clip(det3(Bn) / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    iso = p2 < 1e-30  # isotropic: all eigenvalues equal q
    return jnp.stack(
        [jnp.where(iso, q, e_lo), jnp.where(iso, q, e_mid), jnp.where(iso, q, e_hi)],
        axis=-1,
    )


def _eigvec_sym3(B: jnp.ndarray, lam: jnp.ndarray, fallback: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of symmetric (..., 3, 3) for eigenvalue lam: the
    largest cross product of two rows of (B - lam I) (Eberly's robust
    method). Falls back to `fallback` when lam is (near-)repeated and the
    cross products vanish — any vector of the eigenspace is then valid."""
    M = B - lam[..., None, None] * jnp.eye(3, dtype=B.dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = jnp.stack(
        [jnp.cross(r0, r1), jnp.cross(r0, r2), jnp.cross(r1, r2)], axis=-2
    )
    norms = jnp.linalg.norm(cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    nb = jnp.take_along_axis(norms, best[..., None], axis=-1)
    scale = jnp.sqrt(jnp.sum(B * B, axis=(-2, -1)))[..., None] + 1e-30
    ok = nb > 1e-12 * scale
    return jnp.where(ok, v / (nb + 1e-38), fallback)


def svd3(A: jnp.ndarray):
    """SVD of (..., 3, 3): returns (U, s, Vt) with s descending, like
    jnp.linalg.svd. Signs differ from LAPACK by per-pair flips
    (A ~ U diag(s) Vt holds); all consumers here are flip-invariant.

    V = analytic eigenvectors of A^T A (Cardano eigenvalues + cross-product
    eigenvectors — exact regardless of eigenvalue gaps); U reconstructed as
    A v_i / s_i with Gram-Schmidt + cross-product completion, so U stays
    orthonormal even for the rank-2 matrices (F, E) this library feeds."""
    B = jnp.swapaxes(A, -1, -2) @ A
    w = eigvals3_sym(B)
    ex = jnp.broadcast_to(jnp.eye(3, dtype=A.dtype)[0], w.shape[:-1] + (3,))

    def _perp(v):
        """Any unit vector orthogonal to unit v."""
        a = jnp.cross(v, ex)
        na = jnp.linalg.norm(a, axis=-1, keepdims=True)
        b = jnp.cross(v, jnp.roll(ex, 1, axis=-1))
        nb = jnp.linalg.norm(b, axis=-1, keepdims=True) + 1e-38
        return jnp.where(na > 1e-6, a / (na + 1e-38), b / nb)

    # Extract the better-isolated extreme eigenvector first (the
    # cross-product method degenerates exactly when its eigenvalue is
    # repeated); the other extreme falls back to any perpendicular vector,
    # which IS an eigenvector in that repeated case.
    hi_isolated = (w[..., 2] - w[..., 1]) >= (w[..., 1] - w[..., 0])
    lam1 = jnp.where(hi_isolated, w[..., 2], w[..., 0])
    lam2 = jnp.where(hi_isolated, w[..., 0], w[..., 2])
    v1 = _eigvec_sym3(B, lam1, ex)
    v2 = _eigvec_sym3(B, lam2, _perp(v1))
    v2 = v2 - jnp.sum(v2 * v1, -1, keepdims=True) * v1
    n2 = jnp.linalg.norm(v2, axis=-1, keepdims=True)
    v2 = jnp.where(n2 > 1e-12, v2 / (n2 + 1e-38), _perp(v1))
    v_hi = jnp.where(hi_isolated[..., None], v1, v2)
    v_lo = jnp.where(hi_isolated[..., None], v2, v1)
    v_mid = jnp.cross(v_hi, v_lo)

    V = jnp.stack([v_hi, v_mid, v_lo], axis=-1)  # columns, descending
    s = jnp.sqrt(jnp.maximum(jnp.stack([w[..., 2], w[..., 1], w[..., 0]], -1), 0.0))
    AV = A @ V
    # u_i = A v_i / s_i keeps A == U diag(s) V^T exactly; Gram-Schmidt and
    # cross-product completion cover the rank-deficient tail.
    u0 = AV[..., 0] / (s[..., 0, None] + 1e-30)
    u0 = u0 / (jnp.linalg.norm(u0, axis=-1, keepdims=True) + 1e-30)
    u1 = AV[..., 1] / (s[..., 1, None] + 1e-30)
    u1 = u1 - jnp.sum(u1 * u0, -1, keepdims=True) * u0
    n1 = jnp.linalg.norm(u1, axis=-1, keepdims=True)
    u1 = jnp.where(n1 > 1e-12, u1 / (n1 + 1e-38), _perp(u0))
    u2 = AV[..., 2]
    u2 = u2 - jnp.sum(u2 * u0, -1, keepdims=True) * u0
    u2 = u2 - jnp.sum(u2 * u1, -1, keepdims=True) * u1
    nz = jnp.linalg.norm(u2, axis=-1, keepdims=True)
    u2 = jnp.where(nz > 1e-12 * (s[..., 0, None] + 1e-30),
                   u2 / (nz + 1e-38), jnp.cross(u0, u1))
    U = jnp.stack([u0, u1, u2], axis=-1)
    return U, s, jnp.swapaxes(V, -1, -2)
