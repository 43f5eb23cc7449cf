"""Row-sharded, batch-parallel SGBM over a device mesh.

The dense cost volume is the scale dimension of this project (a 4K x 256
volume is ~2.1G cost entries — SURVEY §5). We shard it two ways:

  batch axis  -> 'data'  (independent pairs, zero communication)
  image rows  -> 'space' (halo exchange at shard boundaries)

Horizontal SGM paths are row-local, so row sharding is free for them.
Vertical/diagonal paths carry state across rows; the exact recurrence is
sequential across shards, so we use the standard halo warm-start scheme
(as in GPU tiled-SGM implementations): each shard receives `halo` extra
rows from its neighbors via `lax.ppermute`, runs its scans from a
zero carry at the extended boundary, and discards the halo outputs. SGM
path influence decays geometrically with P2 smoothing, so a modest halo
(default 32 rows) reproduces the single-device result almost everywhere
(tested >=99% of valid pixels within 1/16 px).

The speckle filter's connected-component flood is ALSO row-sharded:
min-label propagation is a commutative, monotone
fixpoint, so each shard floods its local rows and exchanges only its
boundary-row labels with neighbors via `lax.ppermute` each round until
global quiescence — the converged labels are exactly the single-device
ones (unique fixpoint). Only the component-size epilogue (two label
sorts) runs on all-gathered labels per shard (one (H, W) int32 frame),
replacing the r4 "regather rows, then speckle" serialization that made
speckle the unsharded Amdahl floor of the e2e frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
try:  # jax >= 0.8 promotes shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from stereo_reconstruction_cv_tpu.config import SGBMConfig
from stereo_reconstruction_cv_tpu.ops import disparity as DP

# Rows of cost-volume halo needed for exact C at shard boundaries:
# x-Sobel reads y±1 and the 11x11 block sum reads y±5.
_COST_HALO = 6


def _shift_last(x: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    """x[..., i - s] along the last axis (s > 0 pulls from earlier
    indices, s < 0 from later), `fill` where out of range."""
    n = x.shape[-1]
    if abs(s) >= n:
        return jnp.full_like(x, fill)
    pad = [(0, 0)] * (x.ndim - 1)
    if s > 0:
        return jnp.pad(x[..., :-s], pad + [(s, 0)], constant_values=fill)
    return jnp.pad(x[..., -s:], pad + [(0, -s)], constant_values=fill)


def _capped_run_counts(sl: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Per-element min(run length, cap + 1) of equal-value runs along the
    last axis of a SORTED array — exact for runs <= cap + 1, saturated
    above (sufficient for a `size > cap` test, and for summing capped
    per-shard counts: min(a,c)+min(b,c) > cap <=> a+b > cap for c=cap+1).

    Hillis-Steele doubling on the consecutive-equal indicator: after the
    s-step, r[i] = min(true consecutive count, 2s); 7 steps reach 128 >
    any cap <= 127."""
    eq_prev = jnp.concatenate(
        [jnp.zeros_like(sl[..., :1], jnp.bool_), sl[..., 1:] == sl[..., :-1]],
        axis=-1,
    )
    eq_next = jnp.concatenate(
        [sl[..., 1:] == sl[..., :-1], jnp.zeros_like(sl[..., :1], jnp.bool_)],
        axis=-1,
    )

    def runlen(eq, backward):
        r = eq.astype(jnp.int32)
        s = 1
        while s <= cap:
            sh = _shift_last(r, s if backward else -s, 0)
            r = r + jnp.where(r >= s, sh, 0)
            s *= 2
        return r

    back = runlen(eq_prev, True)    # distance to run start (capped)
    fwd = runlen(eq_next, False)    # distance to run end (capped)
    return jnp.minimum(back + fwd + 1, cap + 1)


def sharded_speckle_filter(
    mesh: Mesh,
    disp: jnp.ndarray,
    valid: jnp.ndarray,
    max_speckle_size: int = 100,
    max_diff: float = 32.0,
    max_rounds: int = 96,
) -> jnp.ndarray:
    """Row-sharded exact cv2.filterSpeckles-parity mask.

    disp/valid: (B, H, W) sharded P('data', 'space', None). The min-label
    flood (the XLA doubling flood) runs shard-locally with ONE boundary-row
    label exchange per round: shard boundaries are just extra relaxation
    edges of the same
    monotone min-fixpoint, so iterating {local flood, boundary merge} to
    global quiescence (psum'd change flag) converges to exactly the
    single-device component labels — the fixpoint is unique regardless of
    relaxation order (confluence).

    The component-size epilogue is ALSO fully sharded (r5) and exact:
      1. per shard, capped local counts per pixel: sort local (label,
         idx), run-length the sorted labels capped at T+1, un-sort the
         capped count (1/ns-sized sorts — these dominated the replicated
         epilogue);
      2. every within-shard piece of a cross-shard component touches one
         of the shard's boundary rows (any path leaving the shard crosses
         them), so boundary-row (label, count) records — 2*W per shard,
         all-gathered (~2*ns*W records, tiny) — cover exactly the labels
         whose local counts are incomplete. Sorting the records by
         (label, shard), deduping per (label, shard), and segment-summing
         per label yields the label's GLOBAL capped count (capped
         summands stay exact for the `> T` test: min(a,c)+min(b,c) > T
         <=> a+b > T when c = T+1);
      3. the global keep bit rides back to each shard's boundary rows
         (small un-sort) and a shard-LOCAL max-flood over the same
         connectivity spreads it to every pixel of the affected
         components (min-flood of 2 - o, monotone and confluent);
         untouched pixels keep their (complete) local decision.

    Reference semantics: speckleWindowSize/speckleRange of
    cv2.StereoSGBM (main.ipynb cell 10 :631 +33-34).
    """
    ns = mesh.shape["space"]
    spec = P("data", "space", None)
    fwd = [(i, i + 1) for i in range(ns - 1)]
    bwd = [(i + 1, i) for i in range(ns - 1)]

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    def run(d, v):
        b, h, W = d.shape
        my = jax.lax.axis_index("space")
        H = h * ns
        sink = jnp.int32(H * W)
        rows = jax.lax.broadcasted_iota(jnp.int32, (b, h, W), 1)
        cols = jax.lax.broadcasted_iota(jnp.int32, (b, h, W), 2)
        lab0 = jnp.where(v, (my * h + rows) * W + cols, sink)

        conn_r = (jnp.abs(d[:, :, 1:] - d[:, :, :-1]) <= max_diff) \
            & v[:, :, 1:] & v[:, :, :-1]
        conn_dn = (jnp.abs(d[:, 1:] - d[:, :-1]) <= max_diff) \
            & v[:, 1:] & v[:, :-1]
        ch = jnp.concatenate([jnp.zeros((b, h, 1), bool), conn_r], axis=2)
        cv = jnp.concatenate([jnp.zeros((b, 1, W), bool), conn_dn], axis=1)

        def from_prev(x):  # shard i receives shard i-1's x
            return jax.lax.ppermute(x, "space", fwd)

        def from_next(x):  # shard i receives shard i+1's x
            return jax.lax.ppermute(x, "space", bwd)

        # Cross-boundary connectivity, computed once (symmetric on both
        # sides of each boundary). Edge shards keep their true-image-edge
        # rows unconnected via the axis_index guards.
        pd, pv = from_prev(d[:, -1]), from_prev(v[:, -1])
        ndn, nv = from_next(d[:, 0]), from_next(v[:, 0])
        conn_top = (jnp.abs(d[:, 0] - pd) <= max_diff) & v[:, 0] & pv & (my > 0)
        conn_bot = (jnp.abs(d[:, -1] - ndn) <= max_diff) & v[:, -1] & nv \
            & (my < ns - 1)

        def merge(lab):
            """Apply the cross-boundary relaxation edges."""
            plab = from_prev(lab[:, -1])
            nlab = from_next(lab[:, 0])
            top = jnp.where(conn_top, jnp.minimum(lab[:, 0], plab), lab[:, 0])
            bot = jnp.where(conn_bot, jnp.minimum(lab[:, -1], nlab), lab[:, -1])
            chg_top = top != lab[:, 0]  # (b, W)
            chg_bot = bot != lab[:, -1]
            lab = lab.at[:, 0].set(top).at[:, -1].set(bot)
            return lab, chg_top, chg_bot

        def global_changed(c):
            return jax.lax.psum(c.astype(jnp.int32), ("data", "space")) > 0

        def local_fixpoint(m):
            def bd(s):
                m_, _, i_ = s
                new = DP._seg_min_flood(m_, ch, axis=2, big=sink)
                new = DP._seg_min_flood(new, cv, axis=1, big=sink)
                return new, global_changed(jnp.any(new != m_)), i_ + 1

            m, c, _ = bd((m, None, jnp.int32(0)))
            m, _, _ = jax.lax.while_loop(
                lambda s: s[1] & (s[2] < max_rounds), bd,
                (m, c, jnp.int32(1)),
            )
            return m

        def step(lab):
            new = DP._seg_min_flood(lab, ch, axis=2, big=sink)
            new = DP._seg_min_flood(new, cv, axis=1, big=sink)
            c1 = jnp.any(new != lab)
            new, chg_top, chg_bot = merge(new)
            changed = c1 | jnp.any(chg_top) | jnp.any(chg_bot)
            return new, global_changed(changed)

        lab, chg = step(lab0)

        def cond(s):
            return s[1] & (s[2] < max_rounds)

        def body(s):
            lab, _, i = s
            lab, chg = step(lab)
            return lab, chg, i + 1

        lab, _, _ = jax.lax.while_loop(cond, body, (lab, chg, jnp.int32(1)))

        # ---- sharded size epilogue (module docstring steps 1-3) ----
        T = int(max_speckle_size)
        Nl = h * W
        flat = lab.reshape(b, Nl)
        idx = jnp.broadcast_to(jnp.arange(Nl, dtype=jnp.int32), (b, Nl))
        sl, si = jax.lax.sort((flat, idx), num_keys=1)
        cnt_sorted = _capped_run_counts(sl, T)  # in [1, T+1]
        # Un-sort the capped count (cnt <= T+1 <= 128 rides 7 low bits;
        # si * 128 < 2^31 for any frame below 16M local pixels).
        packed = jax.lax.sort(si * jnp.int32(128) + cnt_sorted)
        cnt_px = (packed & jnp.int32(127)).reshape(b, h, W)
        if ns == 1:
            return v & (cnt_px > T)

        # Boundary-row (label, count) records, all-gathered (2*ns*W, tiny).
        blab = jnp.stack([lab[:, 0], lab[:, -1]], axis=1)      # (b, 2, W)
        bcnt = jnp.stack([cnt_px[:, 0], cnt_px[:, -1]], axis=1)
        gl = jax.lax.all_gather(blab, "space", axis=1, tiled=True
                                ).reshape(b, 2 * ns * W)
        gc = jax.lax.all_gather(bcnt, "space", axis=1, tiled=True
                                ).reshape(b, 2 * ns * W)
        Mrec = 2 * ns * W
        shard_of = jnp.broadcast_to(
            jnp.arange(Mrec, dtype=jnp.int32) // (2 * W), (b, Mrec)
        )
        pos = jnp.broadcast_to(jnp.arange(Mrec, dtype=jnp.int32), (b, Mrec))
        key = gl * jnp.int32(ns) + shard_of  # (label, shard) lexicographic
        sk, sc, sp = jax.lax.sort((key, gc, pos), num_keys=1)
        one_col = jnp.ones_like(sk[..., :1], jnp.bool_)
        first = jnp.concatenate([one_col, sk[..., 1:] != sk[..., :-1]], axis=-1)
        c_d = jnp.where(first, sc, 0)  # one count per (label, shard)
        slab = sk // jnp.int32(ns)
        conn_rec = jnp.concatenate(
            [~one_col, slab[..., 1:] == slab[..., :-1]], axis=-1
        )
        # Segmented inclusive sum per label (Hillis-Steele), then the
        # segment TOTAL broadcast back via a segmented max-flood.
        vv = c_d
        F = conn_rec
        s_ = 1
        while s_ < Mrec:
            vv = vv + jnp.where(F, _shift_last(vv, s_, 0), 0)
            F = F & _shift_last(F, s_, False)
            s_ *= 2
        tot = -DP._seg_min_flood(-vv, conn_rec, axis=1, big=jnp.int32(1))
        gkeep = tot > T
        # Un-sort the keep bit to record order; slice MY boundary rows.
        packed2 = jax.lax.sort(sp * jnp.int32(2) + gkeep.astype(jnp.int32))
        keep_rec = (packed2 & 1).astype(jnp.bool_).reshape(b, 2 * ns, W)
        keep_b = jax.lax.dynamic_slice_in_dim(keep_rec, my * 2, 2, axis=1)
        # Override max-flood: o in {0 none, 1 remove, 2 keep} seeded on
        # the boundary rows, spread within components as min(2 - o).
        o0 = jnp.zeros((b, h, W), jnp.int32)
        o0 = o0.at[:, 0].set(jnp.where(keep_b[:, 0], 2, 1))
        o0 = o0.at[:, -1].set(jnp.where(keep_b[:, 1], 2, 1))
        o = 2 - local_fixpoint(2 - o0)
        keep = jnp.where(o > 0, o == 2, cnt_px > T)
        return v & keep

    return run(disp, valid)


def sharded_sgbm_disparity(
    mesh: Mesh,
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: SGBMConfig,
    halo: int = 32,
    exact: bool = False,
):
    """(B, H, W) uint8 pairs -> (disparity (B, H, W) f32, valid (B, H, W)).

    Batch is sharded over 'data', rows over 'space'. Call under jit with
    inputs placed via parallel.mesh.batch_row_sharding(mesh).

    exact=True switches from halo warm-start to sequential carry handoff
    (sharded_sgbm_disparity_exact): bit-reproducible across mesh sizes,
    at the cost of serializing the vertical sweeps across 'space'.
    """
    if exact:
        return sharded_sgbm_disparity_exact(mesh, left, right, cfg)
    ns = mesh.shape["space"]
    local_rows = left.shape[1] // ns
    halo = min(halo, local_rows)  # a halo can't exceed a neighbor's rows
    if ns == 1:
        halo = 0  # no spatial sharding -> no boundaries to warm up
    core_cfg = cfg.with_(speckle_window_size=0)
    spec = P("data", "space", None)

    def exchange_halos(x):
        """Append neighbors' boundary rows: (b, h, W) -> (b, halo+h+halo, W).
        Edge shards get zero halos (their scans start at the true image
        boundary, where a zero carry is exact)."""
        top_rows = x[:, :halo]      # sent upward (to previous shard)
        bot_rows = x[:, -halo:]     # sent downward (to next shard)
        from_next = jax.lax.ppermute(
            top_rows, "space", [(i + 1, i) for i in range(ns - 1)]
        )
        from_prev = jax.lax.ppermute(
            bot_rows, "space", [(i, i + 1) for i in range(ns - 1)]
        )
        return jnp.concatenate([from_prev, x, from_next], axis=1)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)
    )
    def run(l, r):
        le = exchange_halos(l) if halo else l
        re = exchange_halos(r) if halo else r
        disp, valid = jax.vmap(lambda a, b: DP.sgbm_disparity(a, b, core_cfg))(le, re)
        if halo:
            disp, valid = disp[:, halo:-halo], valid[:, halo:-halo]
        return disp, valid

    disp, valid = run(left, right)
    if cfg.speckle_window_size > 0:
        valid = _sharded_speckle_with_margin(mesh, disp, valid, cfg)
    return disp, valid


def _sharded_speckle_with_margin(mesh, disp, valid, cfg: SGBMConfig):
    """Sharded speckle on the active columns (the x < minX1 margin is
    invalid by construction — same slicing as ops.disparity._speckle)."""
    x0 = cfg.min_disparity + cfg.num_disparities
    keep = sharded_speckle_filter(
        mesh, disp[:, :, x0:], valid[:, :, x0:],
        cfg.speckle_window_size, float(cfg.speckle_range),
    )
    return jnp.pad(keep, ((0, 0), (0, 0), (x0, 0)), constant_values=False)


# ---------------------------------------------------------------------------
# Exact mode: sequential carry handoff across 'space'
# ---------------------------------------------------------------------------

def _scan_rows_carry(C, dx: int, dy: int, p1: int, p2: int, carry):
    """One vertical/diagonal SGM direction over local rows with an incoming
    DP carry; returns (L volume, outgoing carry).

    Same recurrence as ops.disparity._scan_dir (dy != 0, plain scan), but
    the carry enters/exits so shards can chain exactly: the predecessor of
    a shard's first row is the previous shard's last row, including the
    diagonal column shift (applied to the carry inside the first step,
    exactly as the single-device scan applies it between those two rows)."""
    vol = C if dy > 0 else C[::-1]
    shift = -dx

    def f(c, row):
        prev = DP._shift_cols(c, shift) if dx != 0 else c
        L = DP._sgm_step(prev, row, p1, p2)
        return L, L

    carry_out, out = jax.lax.scan(f, carry, vol)
    return (out if dy > 0 else out[::-1]), carry_out


def _replicated_halos(x, hb: int, ns: int):
    """Append hb neighbor rows on each side of the local row block.

    Interior boundaries receive the neighbor's true rows via ppermute;
    true image edges receive REPLICATED boundary rows, which reproduces
    the mode="edge" padding of the Sobel prefilter and the block sum —
    so the cost volume computed on the extended block, cropped by hb,
    is bit-identical to the single-device one."""
    my = jax.lax.axis_index("space")
    top = x[:, :hb]
    bot = x[:, -hb:]
    from_next = jax.lax.ppermute(top, "space", [(i + 1, i) for i in range(ns - 1)])
    from_prev = jax.lax.ppermute(bot, "space", [(i, i + 1) for i in range(ns - 1)])
    rep_first = jnp.repeat(x[:, :1], hb, axis=1)
    rep_last = jnp.repeat(x[:, -1:], hb, axis=1)
    from_prev = jnp.where(my == 0, rep_first, from_prev)
    from_next = jnp.where(my == ns - 1, rep_last, from_next)
    return jnp.concatenate([from_prev, x, from_next], axis=1)


def sharded_sgbm_disparity_exact(
    mesh: Mesh,
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: SGBMConfig,
):
    """Row-sharded SGBM that is BIT-IDENTICAL to the single-device pipeline
    (ops.disparity.sgbm_disparity, exact aggregation).

    Horizontal paths and every per-pixel stage are row-local; the cost
    volume uses an exact 6-row halo; the vertical/diagonal paths hand
    their (W, D) DP carries shard-to-shard (lax.ppermute) in
    path order — ns sequential rounds, each round computing one shard's
    rows while the others idle. Exactness therefore costs ~ns x the
    vertical-sweep time; use the default halo warm-start mode when
    bit-reproducibility across mesh shapes is not required
    (reference hot loop main.ipynb cell 10)."""
    ns = mesh.shape["space"]
    spec = P("data", "space", None)
    cap = cfg.pre_filter_cap
    x0 = cfg.min_disparity + cfg.num_disparities
    dirs = DP.DIRS_8 if cfg.num_directions == 8 else DP.DIRS_5
    h_dirs = [d for d in dirs if d[1] == 0]
    down_dirs = [d for d in dirs if d[1] == 1]
    up_dirs = [d for d in dirs if d[1] == -1]

    def local_cost(a, b, my):
        """Exact local cost volume from hb-extended row blocks.

        Sobel and BT run on the extended rows (interior halo rows are the
        neighbor's true rows, so their BT is exact given >= 1 row of sobel
        context). At TRUE image edges the halo BT rows are overwritten
        with the edge row's BT: the single-device block_sum edge-pads the
        *cost* rows, and sobel-of-replicated-image-rows does not equal
        the edge row's sobel (it loses the y-gradient)."""
        hb = _COST_HALO
        h = a.shape[0] - 2 * hb
        sl = DP.xsobel_clip(a, cap)
        sr = DP.xsobel_clip(b, cap)
        capv = jnp.int32(cap)
        planes = []
        for p in (sl, sr, a.astype(jnp.int32), b.astype(jnp.int32)):
            planes.append(p.at[:, 0].set(capv).at[:, -1].set(capv))
        sl, sr, rawl, rawr = planes
        C = DP.bt_cost_volume(
            sl, sr, rawl, rawr, cfg.num_disparities, cfg.min_disparity
        )
        top_fix = jnp.repeat(C[hb : hb + 1], hb, axis=0)
        bot_fix = jnp.repeat(C[hb + h - 1 : hb + h], hb, axis=0)
        C = jnp.where((my == 0)[None, None, None],
                      jnp.concatenate([top_fix, C[hb:]], axis=0), C)
        C = jnp.where((my == ns - 1)[None, None, None],
                      jnp.concatenate([C[:-hb], bot_fix], axis=0), C)
        C = DP.block_sum(C[:, x0:, :], cfg.block_size)
        # int16 storage -> int32 for the DP scans (as sgm_aggregate does).
        return C[hb:-hb].astype(jnp.int32)

    def seq_dirs(C, dir_list, reverse_order: bool, ncw: int = 16):
        """Sum of L volumes for directions whose scans cross shards —
        WAVEFRONT-pipelined over column chunks.

        The r4 implementation serialized whole shards: ns rounds, each
        computing one shard's rows while the others' results were
        discarded, costing ~ns x the vertical-sweep work. Here the W axis
        splits into ncw chunks and shard s scans chunk j at wavefront
        step s + j, as soon as the upstream shard's carry for that chunk
        arrives (lax.ppermute) — after an (ns-1)-step fill every
        shard streams continuously, so the cross-shard sweep costs
        (ns-1+ncw)/ncw local passes instead of ns.

        Chunks are processed in the column-shift direction (left-to-right
        for dx >= 0, right-to-left for dx < 0), so both cross-chunk
        dependencies — the upstream shard's carry columns and the +-1
        boundary column of the neighboring chunk (diagonal paths) — are
        always produced at an earlier wavefront step. The boundary column
        is re-fed into the chunk scan row-by-row (edge sequence), which
        reproduces the plain full-width scan's _sgm_step inputs exactly:
        bit-exactness vs the single-device XLA backend is unchanged
        (tests/test_parallel.py::TestExactSharded).

        reverse_order=True (upward paths) flips the shard order; rows are
        flipped by the caller's dy convention below."""
        b, h, Wc, D = C.shape
        my = jax.lax.axis_index("space")
        my_eff = (ns - 1 - my) if reverse_order else my
        perm = (
            [(i, i - 1) for i in range(1, ns)]
            if reverse_order
            else [(i, i + 1) for i in range(ns - 1)]
        )
        while Wc % ncw:
            ncw //= 2
        cw = Wc // ncw
        steps = ns - 1 + ncw
        S = jnp.zeros_like(C)
        for dx, dy in dir_list:
            vol = C if dy > 0 else C[:, ::-1]
            l2r = dx >= 0

            def chunk_start(jc, l2r=l2r):
                return jc * cw if l2r else Wc - (jc + 1) * cw

            def scan_chunk(Cc, carry0, edge_rows, dx=dx):
                """(h, cw, D) chunk scan; edge_rows[r] = L[r-1, boundary]
                (row -1 = the cross-shard carry's boundary column)."""
                def f(cur, inp):
                    c_row, e_row = inp
                    if dx == 0:
                        prev = cur
                    elif dx > 0:
                        prev = jnp.concatenate([e_row[None], cur[:-1]], axis=0)
                    else:
                        prev = jnp.concatenate([cur[1:], e_row[None]], axis=0)
                    L = DP._sgm_step(prev, c_row, cfg.p1, cfg.p2)
                    return L, L

                carry_out, rows = jax.lax.scan(f, carry0, (Cc, edge_rows))
                return rows, carry_out

            vscan = jax.vmap(scan_chunk)

            def body(t, state, dx=dx, vol=vol):
                out, carry_buf = state
                j = t - my_eff
                jc = jnp.clip(j, 0, ncw - 1).astype(jnp.int32)
                a = chunk_start(jc)
                z = jnp.int32(0)
                Cc = jax.lax.dynamic_slice(vol, (z, z, a, z), (b, h, cw, D))
                car = jax.lax.dynamic_slice(carry_buf, (z, a, z), (b, cw, D))
                if dx == 0:
                    edge = jnp.zeros((b, h, D), C.dtype)
                elif dx > 0:
                    outp = jnp.pad(out, ((0, 0), (0, 0), (1, 0), (0, 0)))
                    ecol = jax.lax.dynamic_slice(
                        outp, (z, z, a, z), (b, h, 1, D))[:, :, 0]
                    carp = jnp.pad(carry_buf, ((0, 0), (1, 0), (0, 0)))
                    ce = jax.lax.dynamic_slice(
                        carp, (z, a, z), (b, 1, D))[:, 0]
                    edge = jnp.concatenate([ce[:, None], ecol[:, :-1]], axis=1)
                else:
                    outp = jnp.pad(out, ((0, 0), (0, 0), (0, 1), (0, 0)))
                    ecol = jax.lax.dynamic_slice(
                        outp, (z, z, a + cw, z), (b, h, 1, D))[:, :, 0]
                    carp = jnp.pad(carry_buf, ((0, 0), (0, 1), (0, 0)))
                    ce = jax.lax.dynamic_slice(
                        carp, (z, a + cw, z), (b, 1, D))[:, 0]
                    edge = jnp.concatenate([ce[:, None], ecol[:, :-1]], axis=1)
                rows, carry_out = vscan(Cc, car, edge)
                active = (j >= 0) & (j < ncw)
                old = jax.lax.dynamic_slice(out, (z, z, a, z), (b, h, cw, D))
                out = jax.lax.dynamic_update_slice(
                    out, jnp.where(active, rows, old), (z, z, a, z)
                )
                # Ship this chunk's exit carry downstream; it lands in the
                # receiver's carry_buf at the SENDER's chunk id
                # j_recv = t - (my_eff - 1) (garbage guarded by range).
                sent = jax.lax.ppermute(carry_out, "space", perm)
                jr = t - my_eff + 1
                ar = chunk_start(jnp.clip(jr, 0, ncw - 1).astype(jnp.int32))
                oldc = jax.lax.dynamic_slice(carry_buf, (z, ar, z), (b, cw, D))
                okr = (jr >= 0) & (jr < ncw)
                carry_buf = jax.lax.dynamic_update_slice(
                    carry_buf, jnp.where(okr, sent, oldc), (z, ar, z)
                )
                return out, carry_buf

            out0 = jnp.zeros_like(C)
            cb0 = jnp.zeros_like(C[:, 0])
            out, _ = jax.lax.fori_loop(0, steps, body, (out0, cb0))
            S = S + (out if dy > 0 else out[:, ::-1])
        return S

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)
    )
    def run(l, r):
        my = jax.lax.axis_index("space")
        le = _replicated_halos(l, _COST_HALO, ns)
        re = _replicated_halos(r, _COST_HALO, ns)
        C = jax.vmap(lambda a, b: local_cost(a, b, my))(le, re)
        # Horizontal paths stay inside a shard's rows: the exact sweeps.
        S = jax.vmap(
            lambda c: DP.sgm_aggregate_exact(c, cfg.p1, cfg.p2, h_dirs)
        )(C)
        S = S + seq_dirs(C, down_dirs, reverse_order=False)
        if up_dirs:
            S = S + seq_dirs(C, up_dirs, reverse_order=True)
        disp, valid = jax.vmap(
            lambda s: DP.wta_disparity(s, cfg.min_disparity, cfg.uniqueness_ratio)
        )(S)
        if cfg.disp12_max_diff >= 0:
            valid &= jax.vmap(
                lambda s, d: DP.lr_check(
                    s, d, cfg.min_disparity, cfg.disp12_max_diff
                )
            )(S, disp)
        disp = jnp.pad(
            disp, ((0, 0), (0, 0), (x0, 0)),
            constant_values=float(cfg.min_disparity - 1),
        )
        valid = jnp.pad(valid, ((0, 0), (0, 0), (x0, 0)), constant_values=False)
        return disp, valid

    disp, valid = run(left, right)
    if cfg.speckle_window_size > 0:
        valid = _sharded_speckle_with_margin(mesh, disp, valid, cfg)
    return disp, valid
