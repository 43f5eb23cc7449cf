"""Batched Nistér-style 5-point essential solver, batched on the device.

cv2.findEssentialMat runs Nistér's 5-point minimal solver inside RANSAC
(reference gui.py:142); round 1/2 substituted the normalized 8-point
algorithm, which is degenerate for planar scenes (PARITY.md deviation 2).
This module removes that caveat with a 5-point solver designed for the
batched-hypothesis engine (ops/robust.py): every step is closed-form or
fixed-iteration — no LAPACK lowerings, no eigensolver — so hundreds of
minimal problems solve simultaneously under vmap/jit.

Method (hidden-variable resultant, Li & Hartley style rather than
Nistér's Gauss-Jordan + companion eigendecomposition):

 1. Null space: the 5x9 epipolar constraint matrix Q has a 4-dim null
    space {E1..E4}; extracted by blocked inverse iteration on Q^T Q
    (Cholesky + Gram-Schmidt, ops/linalg.py machinery).
 2. E(x,y,z) = x E1 + y E2 + z E3 + E4 must satisfy det(E) = 0 and
    2 E E^T E - tr(E E^T) E = 0: ten cubic polynomials in (x, y, z).
    Their coefficients over the 20 cubic monomials are recovered
    NUMERICALLY: evaluate each constraint at 20 fixed generic points and
    multiply by a precomputed (float64) inverse Vandermonde — no
    symbolic expansion to get wrong.
 3. Hidden variable: group by the 10 monomials in (x, y) only; the
    system becomes M(z) m(x, y) = 0 with M polynomial in z (degree <= 3
    per entry). Real solutions require g(z) = det M(z) = 0, a degree-10
    polynomial (column degree caps 4x0+3x1+2x2+1x3 = 10).
 4. Roots: homogenize z = s/c on the circle (c, s) = (cos t, sin t) so
    G(t) = det M~(c, s) is bounded; scan a 256-point grid for sign
    changes (<= 10 exist) and bisect each a fixed 42 iterations. det of
    the 10x10 is an unrolled partially-pivoted LU (static shape).
 5. Back-substitute: null vector of M~(c*, s*) gives (x c, y c) ratios;
    E = (xc) E1 + (yc) E2 + s E3 + c E4 is division-free in c, then
    projected exactly onto the essential manifold (svd3).

Returns all (<= 10) real candidates per sample; the robust engine scores
every candidate of every sample as an independent hypothesis.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.ops import linalg as LA

# ---------------------------------------------------------------------------
# Fixed combinatorics: monomial bases and the coefficient-extraction inverse
# ---------------------------------------------------------------------------

# The 10 monomials in (x, y) of degree <= 3, hidden-variable column order.
MONO_XY = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
# Max z-degree of each column's coefficient polynomial (3 - xy-degree).
Z_CAP = [3 - a - b for a, b in MONO_XY]
# Enumerated (a, b, c) monomials of the full cubic system (20 of them),
# grouped per xy-column so coefficient rows slice out contiguously.
MONOMIALS = [(a, b, c) for (a, b), cap in zip(MONO_XY, Z_CAP) for c in range(cap + 1)]
_COL_OFFSETS = np.cumsum([0] + [c + 1 for c in Z_CAP])  # 11 offsets

_N_GRID = 256          # sign-change scan resolution over the root circle
_N_BISECT = 42         # bisection iterations per root
MAX_ROOTS = 10


def _make_vinv() -> np.ndarray:
    """Inverse of the evaluation matrix V[t, k] = mono_k(p_t) for 20 fixed
    generic points, in float64 (a module-load-time constant)."""
    rng = np.random.default_rng(5)
    for _ in range(64):
        pts = rng.standard_normal((20, 3)) * 0.8
        V = np.stack(
            [[x ** a * y ** b * z ** c for (a, b, c) in MONOMIALS] for x, y, z in pts]
        )
        if np.linalg.cond(V) < 200.0:  # keep extraction well in f32 range
            return np.linalg.inv(V), pts
    raise RuntimeError("could not find well-conditioned evaluation points")


_VINV_np, _EVAL_PTS_np = _make_vinv()


def _constants(dtype):
    return (
        jnp.asarray(_VINV_np, dtype),
        jnp.asarray(_EVAL_PTS_np, dtype),
    )


# ---------------------------------------------------------------------------
# Small building blocks
# ---------------------------------------------------------------------------

def _nullspace4_9(Q: jnp.ndarray, iters: int = 10) -> jnp.ndarray:
    """(5, 9) -> (4, 9) orthonormal basis of the (generic) null space via
    blocked inverse iteration on Q^T Q + eps*I (Cholesky solves +
    Gram-Schmidt; the four zero eigenvalues dominate instantly)."""
    A = Q.T @ Q
    tr = jnp.trace(A)
    shift = 1e-6 * tr / 9.0 + 1e-30
    L = LA.chol(A + shift * jnp.eye(9, dtype=A.dtype))
    # Fixed, mutually-independent start vectors.
    X = jnp.asarray(np.random.default_rng(7).standard_normal((4, 9)), A.dtype)
    for _ in range(iters):
        X = jax.vmap(lambda b: LA.chol_solve(L, b))(X)
        # Gram-Schmidt rows.
        rows = []
        for i in range(4):
            v = X[i]
            for u in rows:
                v = v - jnp.dot(v, u) * u
            rows.append(v / (jnp.linalg.norm(v) + 1e-30))
        X = jnp.stack(rows)
    return X


def _constraints(E: jnp.ndarray) -> jnp.ndarray:
    """The ten cubic invariants of a valid essential matrix, stacked:
    [det E, vec(2 E E^T E - tr(E E^T) E)]. E: (..., 3, 3) -> (..., 10)."""
    EEt = E @ jnp.swapaxes(E, -1, -2)
    tr = jnp.trace(EEt, axis1=-2, axis2=-1)[..., None, None]
    T = 2.0 * (EEt @ E) - tr * E
    return jnp.concatenate(
        [LA.det3(E)[..., None], T.reshape(*T.shape[:-2], 9)], axis=-1
    )


def _det_lu(A: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., n, n) by unrolled partially-pivoted LU
    (static n, batched; no LAPACK lowering)."""
    n = A.shape[-1]
    det = jnp.ones(A.shape[:-2], A.dtype)
    row_iota = jnp.arange(n)
    for k in range(n):
        col = jnp.abs(A[..., :, k])
        col = jnp.where(row_iota >= k, col, -1.0)
        p = jnp.argmax(col, axis=-1)  # pivot row >= k
        onehot = (row_iota == p[..., None]).astype(A.dtype)  # (..., n)
        pivrow = jnp.sum(A * onehot[..., :, None], axis=-2)  # (..., n)
        rowk = A[..., k, :]
        A = A.at[..., k, :].set(pivrow)
        # Put the old row k where the pivot row was (no-op when p == k,
        # since then pivrow == rowk).
        A = A - onehot[..., :, None] * (pivrow - rowk)[..., None, :]
        det = det * jnp.where(p == k, 1.0, -1.0)
        piv = A[..., k, k]
        det = det * piv
        safe = jnp.where(jnp.abs(piv) < 1e-30, 1.0, piv)
        fac = jnp.where(row_iota > k, A[..., :, k] / safe[..., None], 0.0)
        A = A - fac[..., :, None] * A[..., k : k + 1, :]
    return det


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

def essential_5pt(npts1: jnp.ndarray, npts2: jnp.ndarray):
    """Minimal 5-point solve on K-normalized coordinates.

    npts1, npts2: (5, 2). Returns (E (10, 3, 3) unit-norm candidates,
    valid (10,) bool) — one entry per real root, invalid slots arbitrary.
    """
    dtype = npts1.dtype
    Vinv, eval_pts = _constants(dtype)

    x1, y1 = npts1[:, 0], npts1[:, 1]
    x2, y2 = npts2[:, 0], npts2[:, 1]
    ones = jnp.ones_like(x1)
    Q = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )  # (5, 9)
    B = _nullspace4_9(Q)  # (4, 9)
    E1, E2, E3, E4 = (B[i].reshape(3, 3) for i in range(4))

    # --- numeric coefficient extraction over the 20 cubic monomials ------
    px, py, pz = eval_pts[:, 0], eval_pts[:, 1], eval_pts[:, 2]
    Es = (
        px[:, None, None] * E1
        + py[:, None, None] * E2
        + pz[:, None, None] * E3
        + E4
    )  # (20, 3, 3)
    vals = _constraints(Es)            # (20, 10)
    coeffs = (Vinv @ vals).T           # (10, 20): rows = equations
    # Equation scaling (rows of the resultant matrix) for conditioning.
    coeffs = coeffs / (jnp.linalg.norm(coeffs, axis=-1, keepdims=True) + 1e-30)

    # Per-column z-coefficients, zero-padded to degree 3:
    # zco[j, k] = (10,) coefficient of z^k in column j.
    zco = jnp.zeros((10, 4, 10), dtype)
    for j in range(10):
        for k in range(Z_CAP[j] + 1):
            zco = zco.at[j, k].set(coeffs[:, _COL_OFFSETS[j] + k])

    def M_tilde(c, s):
        """Homogenized resultant matrix at z = s/c: column j times c^cap_j.
        c, s scalars -> (10, 10)."""
        cols = []
        for j in range(10):
            cap = Z_CAP[j]
            col = jnp.zeros((10,), dtype)
            for k in range(cap + 1):
                col = col + zco[j, k] * (s ** k) * (c ** (cap - k))
            cols.append(col)
        return jnp.stack(cols, axis=-1)  # (10, 10)

    def G(theta):
        return _det_lu(M_tilde(jnp.cos(theta), jnp.sin(theta)))

    # --- root scan: sign changes of G on the open circle ------------------
    thetas = (jnp.arange(_N_GRID, dtype=dtype) + 0.5) / _N_GRID * jnp.pi - jnp.pi / 2
    g = jax.vmap(G)(thetas)
    change = (g[:-1] * g[1:]) < 0  # at most 10 (degree bound)
    score = change.astype(dtype) * 2.0 - jnp.arange(_N_GRID - 1, dtype=dtype) * 1e-9
    _, idx = jax.lax.top_k(score, MAX_ROOTS)
    valid = change[idx]

    lo = thetas[idx]
    hi = thetas[jnp.minimum(idx + 1, _N_GRID - 1)]
    glo = g[idx]

    def bisect(state, _):
        lo, hi, glo = state
        mid = 0.5 * (lo + hi)
        gm = jax.vmap(G)(mid)
        left = (glo * gm) > 0  # root in the right half
        lo = jnp.where(left, mid, lo)
        glo = jnp.where(left, gm, glo)
        hi = jnp.where(left, hi, mid)
        return (lo, hi, glo), None

    (lo, hi, _), _ = jax.lax.scan(bisect, (lo, hi, glo), None, length=_N_BISECT)
    troot = 0.5 * (lo + hi)
    c = jnp.cos(troot)
    s = jnp.sin(troot)

    # --- back-substitution: null vector of M~ gives (x c, y c) -----------
    def back(ci, si):
        Mt = M_tilde(ci, si)
        m = LA.smallest_eigvec(Mt.T @ Mt, iters=8)
        # Column scaling: m[j] ~ x^a y^b c^(3 - a - b) (global scale free):
        # m[7]/m[9] = x c, m[8]/m[9] = y c.
        den = m[9]
        ok = jnp.abs(den) > 1e-7
        safe = jnp.where(ok, den, 1.0)
        a = m[7] / safe
        b = m[8] / safe
        E = a * E1 + b * E2 + si * E3 + ci * E4
        return E, ok

    Ecand, ok = jax.vmap(back)(c, s)
    valid = valid & ok
    # Exact essential-manifold projection (also normalizes scale).
    u, sv, vt = LA.svd3(Ecand)
    sm = 0.5 * (sv[:, 0] + sv[:, 1])
    proj = (u * jnp.stack([sm, sm, jnp.zeros_like(sm)], -1)[:, None, :]) @ vt
    nrm = jnp.sqrt(jnp.sum(proj * proj, axis=(-2, -1)))[:, None, None]
    E_out = proj / (nrm + 1e-30)
    valid = valid & (nrm[:, 0, 0] > 1e-12)
    return E_out, valid
