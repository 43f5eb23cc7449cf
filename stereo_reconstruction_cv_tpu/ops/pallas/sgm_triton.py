"""Semi-global path aggregation as Pallas sweeps through Triton (GPU).

Bit-identical to the XLA reference `ops.disparity.sgm_aggregate` (exact
scans): the same int32 recurrence

    L_r(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d+-1) + P1,
                              min_k L(p-r, k) + P2) - min_k L(p-r, k)

summed over the path directions into S.

Layout of the work. One `pallas_call` per direction r = (dx, dy). Every
path of that direction is a *line* of the (H, Wc) grid: a row for the
horizontal paths, a column for the vertical ones, and a diagonal
`x - dx * y = c` for the diagonal ones. A program owns a band of
`_LINES_PER_PROGRAM` neighbouring lines and walks them from their start to
their end in one loop, with the (lines, D) DP carry kept on the chip; the
XLA scan instead pays one round trip of the full-width carry through
device memory per step. Lines enter and leave the image along the walk
(diagonals do); positions outside the image are masked and carry a zero,
which is exactly the path-start convention of the reference (a zero
predecessor gives L = C).

The +-1 neighbours along D are the one step Triton's block model cannot
express as a register shuffle, so the carry takes a short trip through a
per-program scratch buffer (L1/L2 resident): store, block barrier, two
shifted masked loads. The buffer is double-buffered by step parity, so one
barrier per step suffices.

The cost volume is read at its storage width (int16 from
`ops.disparity.block_sum`) and S is accumulated in place across
directions (`input_output_aliases`); the first direction writes S without
reading it.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Neighbour value beyond the ends of the disparity axis (as _sgm_step's
# edge padding): never the minimum, and BIG + P1 cannot overflow int32.
_BIG = 1 << 29

# Tile: lines per program and warps per program. 8 x 4 was the fastest of
# 8/16/32 lines x 4/8 warps for every direction type at 4K x 256 on an
# H100 (PERF.md).
_LINES_PER_PROGRAM = 8
_NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _geometry(dx: int, dy: int, H: int, Wc: int) -> Tuple[int, int, int]:
    """(number of lines, steps per line, first diagonal offset c_min)."""
    if dy == 0:
        return H, Wc, 0
    n_lines = Wc + (H - 1) * abs(dx)
    c_min = -(H - 1) if dx > 0 else 0
    return n_lines, H, c_min


def _sweep_kernel(*refs, dx, dy, H, Wc, D, Dp, TL, p1, p2, first, interpret):
    if first:
        c_ref, s_ref, scr_ref = refs
        s_in_ref = None
    else:
        c_ref, s_in_ref, s_ref, scr_ref = refs
    pid = pl.program_id(0)
    n_lines, n_steps, c_min = _geometry(dx, dy, H, Wc)
    lidx = jnp.arange(TL, dtype=jnp.int32)
    d = jnp.arange(Dp, dtype=jnp.int32)
    dmask = d < D
    line = pid * TL + lidx
    live = line < n_lines
    up_idx = jnp.minimum(d + 1, Dp - 1)
    dn_idx = jnp.maximum(d - 1, 0)

    if dy == 0:
        t_lo, t_hi = jnp.int32(0), jnp.int32(n_steps)
    else:
        # Steps at which some line of this band is inside the image.
        c0 = pid * TL + c_min
        if dx > 0:    # x = c + t
            t_lo = jnp.maximum(0, -(c0 + TL - 1))
            t_hi = jnp.minimum(n_steps, Wc - c0)
        elif dx < 0:  # x = c - t
            t_lo = jnp.maximum(0, c0 - Wc + 1)
            t_hi = jnp.minimum(n_steps, c0 + TL)
        else:
            t_lo, t_hi = jnp.int32(0), jnp.int32(n_steps)

    def position(t):
        """(row index, column index, in-image mask), each (TL, 1).

        Masked lanes get an index past the end of the array (never a
        negative one), so no masked lane aliases a live one."""
        if dy == 0:
            x = t if dx > 0 else Wc - 1 - t
            inb = live
            y = jnp.where(inb, line, H)
            xs = jnp.full((TL,), x, jnp.int32)
            return y[:, None], xs[:, None], inb[:, None]
        y = t if dy > 0 else H - 1 - t
        x = line + c_min + dx * t
        inb = live & (x >= 0) & (x < Wc)
        ys = jnp.full((TL,), y, jnp.int32)
        return ys[:, None], jnp.where(inb, x, Wc)[:, None], inb[:, None]

    def step(t, prev):
        y, x, inb = position(t)
        m = inb & dmask[None, :]
        dd = d[None, :]
        cost = plgpu.load(c_ref.at[y, x, dd], mask=m, other=0).astype(jnp.int32)
        slot = t % 2
        plgpu.store(scr_ref.at[pid, slot, lidx[:, None], d[None, :]], prev)
        if not interpret:  # the interpreter runs a program's threads in order
            plgpu.debug_barrier()
        up = plgpu.load(scr_ref.at[pid, slot, lidx[:, None], up_idx[None, :]],
                        mask=(d + 1 < Dp)[None, :], other=_BIG)
        dn = plgpu.load(scr_ref.at[pid, slot, lidx[:, None], dn_idx[None, :]],
                        mask=(d >= 1)[None, :], other=_BIG)
        min_prev = jnp.min(prev, axis=1, keepdims=True)
        best = jnp.minimum(jnp.minimum(prev, min_prev + p2),
                           jnp.minimum(up, dn) + p1)
        L = cost + best - min_prev
        L = jnp.where(dmask[None, :], jnp.where(inb, L, 0), _BIG)
        if first:
            plgpu.store(s_ref.at[y, x, dd], L, mask=m)
        else:
            s = plgpu.load(s_in_ref.at[y, x, dd], mask=m, other=0)
            plgpu.store(s_ref.at[y, x, dd], s + L, mask=m)
        return L

    carry0 = jnp.where(dmask[None, :], jnp.zeros((TL, Dp), jnp.int32), _BIG)
    jax.lax.fori_loop(t_lo, t_hi, step, carry0)


def _sweep(C, S, dx, dy, p1, p2, interpret):
    H, Wc, D = C.shape
    Dp = _next_pow2(D)
    TL = _LINES_PER_PROGRAM
    n_lines, _, _ = _geometry(dx, dy, H, Wc)
    n_prog = pl.cdiv(n_lines, TL)
    first = S is None
    kernel = functools.partial(
        _sweep_kernel, dx=dx, dy=dy, H=H, Wc=Wc, D=D, Dp=Dp, TL=TL,
        p1=p1, p2=p2, first=first, interpret=interpret,
    )
    vma = jax.typeof(C).vma  # varying mesh axes, when called under shard_map
    out_shape = (
        jax.ShapeDtypeStruct((H, Wc, D), jnp.int32, vma=vma),
        jax.ShapeDtypeStruct((n_prog, 2, TL, Dp), jnp.int32, vma=vma),  # carry scratch
    )
    call = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_prog,),
        input_output_aliases={} if first else {1: 0},
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name=f"sgm_sweep_dx{dx}_dy{dy}".replace("-", "m"),
    )
    S_new, _ = call(C) if first else call(C, S)
    return S_new


def sgm_aggregate_triton(
    C: jnp.ndarray,
    p1: int,
    p2: int,
    directions: Sequence[Tuple[int, int]],
    interpret: bool = False,
) -> jnp.ndarray:
    """Sum of per-direction DP aggregations, (H, W, D) int -> int32.

    Same result as `ops.disparity.sgm_aggregate(C, p1, p2, directions,
    chunk=None)`, bit for bit. `interpret=True` runs the kernels in the
    Pallas interpreter (CPU tests)."""
    S = None
    for dx, dy in directions:
        S = _sweep(C, S, dx, dy, int(p1), int(p2), interpret)
    return S
