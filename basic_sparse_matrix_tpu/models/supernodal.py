"""Supernodal sparse Cholesky — panel-granular, matmul-driven numeric phase.

The scatter-list factorization (:mod:`models.sparse_cholesky`) spends one
int32 triple per flop and runs updates elementwise. This module raises the
granularity to **supernode panels**: columns with identical below-diagonal
structure (fundamental supernodes, ``runtime/symbolic.supernodes``) factor
as one dense panel, and every inter-supernode update is a dense outer
product ``L_d[I,:] @ L_d[J,:]ᵀ`` — a batched matmul across all updates
of a level. Panel finalisation is a batched dense Cholesky + triangular
solve over the level's supernodes.

Schedule (host, numpy):
* full symbolic pattern → CSC (diagonal-first columns)
* fundamental supernode partition; panel row set F_s = [c0..c1) + below rows
  (identical for every column in the panel by the fundamental property)
* supernode etree → fan-in levels (update sources always in earlier levels)
* per level, padded index tables into L's flat CSC value array for
  - update gathers (source panel row/col slices) and scatters (targets)
  - panel top-triangle and below-block gathers/scatters

Numeric (device, one jit): ``lax.fori_loop`` over levels; each level does
one batched ``einsum('uiw,ujw->uij')`` + scatter-add, then a batched
``cholesky``/``solve_triangular`` over panels. All padding lands in a
scratch slot that is re-zeroed each step.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.csr import CSR
from ..runtime import symbolic
from ..utils.config import factor_precision
from ..utils.errors import NonSquareMatrix, check

# Max update-table buckets per fan-in level (see the bucketing comment in
# analyze_supernodal): more buckets bound padding tighter but add dispatch
# steps; 3 keeps ND separator levels from inflating leaf-update tables.
# Levels whose single-stack tables are under _BUCKET_MIN_VOLUME entries (or
# within 2x of the bucketed volume) are never split.
_MAX_BUCKETS = 3
_BUCKET_MIN_VOLUME = 1 << 20


# Per-group table names, in _group_tabs order. Each is stored packed in
# one of the three flat device buffers (see SupernodalSchedule.layout);
# host-side numpy copies are kept on the ORIGINAL analyze instance under
# these names (resolved by __getattr__) for the distributed splitter and
# inspection.
_TABLE_NAMES = ("upd_base", "upd_meta", "upd_irows", "upd_ibelow",
                "upd_jrows", "upd_jcp", "panel_cp", "panel_r", "top_valid",
                "tgt_cp", "tgt_nrows", "tgt_w", "upd_seg")
_TABLE_INDEX = {name: i for i, name in enumerate(_TABLE_NAMES)}


@dataclasses.dataclass(frozen=True)
class SupernodalSchedule:
    """Level tables padded PER LEVEL (not globally — under nested-dissection
    orderings the top separator panels are 10-100x the leaf panels, and
    global padding blew the tables up ~150x: 66 s host analyze at n=4096 in
    round 1 vs <0.3 s now), then consecutive same-shape levels are stacked
    into GROUPS. The numeric phase unrolls over groups and ``lax.scan``s
    within each: chain-like etrees (RCM orderings — hundreds of identical
    levels) compile as a few scanned groups instead of a hundreds-deep
    unrolled graph, while heterogeneous ND levels keep their own shapes.

    Tables (13 per group, see ``_TABLE_NAMES``; every table's leading axis
    is the group's level count g) are PACKED into three flat device
    buffers, one per dtype, with a static ``layout`` describing each
    table's (buffer, offset, shape). A 263-group n=36k schedule has
    ~3,400 tables; packing makes the upload 3 transfers, and
    ``_group_tabs`` slices tables back out at TRACE time (static offsets —
    free inside the numeric programs).

    Compact-table semantics (why the tables are small): the full
    (U, I, W)/(U, J, W)/(U, I, J) update position arrays are O(flops) and
    measured 3 GB at n=36k; positions are affine-or-gathered functions of
    O(I+J+W) per-update vectors, so the numeric phase rebuilds them IN
    REGISTER (see _upd_positions) instead of reading them from memory.
    upd_base (g,U,W) source col base; upd_meta (g,U,4) = (ni,nj,hi_s,c0_s);
    upd_irows/_ibelow (g,U,I) target rows / below ranks; upd_jrows/_jcp
    (g,U,J) target cols / col_ptr; panel_cp (g,S,W) col_ptr, panel_r (g,S)
    below counts, top_valid (g,S,W); tgt_cp (g,St,Wt), tgt_nrows/tgt_w
    (g,St), upd_seg (g,U) — the delta-scatter target-panel tables."""

    # A scatter (same as scalar path)
    a_src_pos: jax.Array
    a_vals_idx: jax.Array
    # packed per-group tables (see class docstring / _TABLE_NAMES)
    flat_i32: jax.Array
    flat_u16: jax.Array
    flat_bool: jax.Array
    # static: per group, per table: (buffer id, flat offset, shape)
    layout: Tuple = dataclasses.field(metadata=dict(static=True))
    # static per-group max below-row count (the rebuilt below-block's R
    # axis — a shape, so it lives in meta, not data)
    panel_rmax: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))
    # static per-group target-rect row count (delta formulation) and the
    # host's per-group formulation choice (True = delta wins the
    # scatter-element count comparison)
    delta_rmax: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))
    use_delta: Tuple[bool, ...] = dataclasses.field(
        metadata=dict(static=True))
    # static per-group: window gathers win the read side (long runs, see
    # the cost rule in analyze_supernodal)
    use_window: Tuple[bool, ...] = dataclasses.field(
        metadata=dict(static=True))
    nnz_l: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_groups(self) -> int:
        return len(self.layout)

    def __getattr__(self, name):
        # Host-side numpy table access by the pre-pack field names
        # (distributed splitter, tests, size accounting). Available on the
        # instance analyze_supernodal returned; pytree reconstruction
        # (e.g. inside jit) drops host-only attributes.
        ti = _TABLE_INDEX.get(name)
        if ti is not None:
            tabs = self.__dict__.get("_host_tabs")
            if tabs is None:
                raise AttributeError(
                    f"{name}: host tables unavailable on reconstructed "
                    f"schedules (use _group_tabs for device access)")
            return tabs[ti]
        raise AttributeError(name)


jax.tree_util.register_dataclass(
    SupernodalSchedule,
    data_fields=["a_src_pos", "a_vals_idx", "flat_i32", "flat_u16",
                 "flat_bool"],
    meta_fields=["layout", "panel_rmax", "delta_rmax", "use_delta",
                 "use_window", "nnz_l", "n"],
)

# Rect-merge temp budget (elements): levels whose one-hot merge temps
# exceed this scan U-chunks instead (see _delta_scatter).
_MERGE_CHUNK_ELEMS = 1 << 27

# Options for compiling the numeric programs. On the GPU, XLA autotunes
# every batched product of every level group, and that was half of the
# compile time (one 48-group chunk of the k=33 3D Laplacian: 60 s with
# autotuning, 27 s without, on an H100), for products too small to gain
# from the tuning. The options are ignored on other backends.
XLA_COMPILE_OPTIONS = {"xla_gpu_autotune_level": 0}


def _q(x: int) -> int:
    """Table dims are rounded up to powers of two, so that more consecutive
    levels share one shape and scan as one group (k=33 3D Laplacian: 385
    groups unrounded, 239 rounded): each group costs far more to compile
    than the extra padding costs to run."""
    return 1 << max(int(x) - 1, 0).bit_length()


def _upd_positions(base, meta, irows, ibelow, jrows, jcp, scratch,
                   build_gathers: bool = True, build_scatter: bool = True):
    """Rebuild the (U, I, W)/(U, J, W)/(U, I, J) update position arrays
    from the compact per-update vectors — integer work, no position tables.
    Source-panel gathers are affine (pos = base[col] + rank); the scatter
    is affine in-panel and one precomputed below-rank otherwise. Padding
    slots all land on ``scratch`` (gathers read the re-zeroed slot,
    scatters drop/are re-zeroed). The flags skip unneeded outputs (the
    window-read and delta-scatter paths each replace one side)."""
    U_, W = base.shape
    I = irows.shape[1]
    J = jrows.shape[1]
    # Row/rank tables ride memory (and the host->device upload) as uint16 when
    # n fits (analyze narrows them); widen in register for the arithmetic.
    irows = irows.astype(jnp.int32)
    ibelow = ibelow.astype(jnp.int32)
    jrows = jrows.astype(jnp.int32)
    ii = jnp.arange(I, dtype=jnp.int32)
    jj = jnp.arange(J, dtype=jnp.int32)
    ni = meta[:, 0]
    nj = meta[:, 1]
    his = meta[:, 2]
    ga = gb = sc = None
    if build_gathers:
        vb = base != scratch                                 # (U, W)
        ga = jnp.where(
            (ii[None, :, None] < ni[:, None, None]) & vb[:, None, :],
            base[:, None, :] + ii[None, :, None], scratch)
        gb = jnp.where(
            (jj[None, :, None] < nj[:, None, None]) & vb[:, None, :],
            base[:, None, :] + jj[None, :, None], scratch)
    if build_scatter:
        ir = irows[:, :, None]                               # (U, I, 1)
        jr = jrows[:, None, :]                               # (U, 1, J)
        cpj = jcp[:, None, :]
        valid = ((ii[None, :, None] < ni[:, None, None])
                 & (jj[None, None, :] < nj[:, None, None])
                 & (ir >= jr))
        in_panel = ir < his[:, None, None]
        pos = jnp.where(in_panel, cpj + ir - jr,
                        cpj + (his[:, None, None] - jr)
                        + ibelow[:, :, None])
        sc = jnp.where(valid, pos, scratch)
    return ga, gb, sc


def _win(lvals, starts, L: int):
    """Batched contiguous-window gather: one gather issue per start
    (lowered from vmapped dynamic_slice) instead of one per ELEMENT —
    the supernodal numeric phase's gathers are all ``base + rank`` runs,
    so this replaces U·I·W scalar issues with U·W."""
    return jax.vmap(jax.vmap(
        lambda s: jax.lax.dynamic_slice(lvals, (s,), (L,))))(starts)


def _upd_windows(lvals, base, meta, scratch, I: int, J: int):
    """Window-gather form of the update reads (A, B operands of the level
    einsum). ``lvals`` must carry >= max(I, J) zero padding past the
    scratch slot so clamped slices stay in the pad; lanes beyond each
    update's (ni, nj) or on padded columns are masked to zero (window
    spill past a short source run is masked the same way)."""
    ni = meta[:, 0]
    nj = meta[:, 1]
    vb = base != scratch
    ii = jnp.arange(I, dtype=jnp.int32)
    jj = jnp.arange(J, dtype=jnp.int32)
    A = jnp.swapaxes(_win(lvals, base, I), 1, 2)             # (U, I, W)
    A = jnp.where((ii[None, :, None] < ni[:, None, None])
                  & vb[:, None, :], A, 0.0)
    B = jnp.swapaxes(_win(lvals, base, J), 1, 2)             # (U, J, W)
    B = jnp.where((jj[None, :, None] < nj[:, None, None])
                  & vb[:, None, :], B, 0.0)
    return A, B


def _panel_windows(lvals, cp, tv, r_tab, R: int):
    """Window-gather form of the panel reads (top triangle + below block).
    T[s, i, j] = lvals[cp[s, j] + i - j] → per-(s, j) window at cp - j;
    B[s, r, j] = lvals[cp[s, j] + w_s - j + r] → window at cp + w_s - j."""
    S, W = cp.shape
    il = jnp.arange(W, dtype=jnp.int32)
    w = tv.sum(axis=-1).astype(jnp.int32)
    T = jnp.swapaxes(_win(lvals, cp - il[None, :], W), 1, 2)   # (S, i, j)
    tri = tv[:, :, None] & tv[:, None, :] & (
        il[:, None] >= il[None, :])[None]
    T = jnp.where(tri, T, 0.0)
    Bp = jnp.swapaxes(
        _win(lvals, cp + w[:, None] - il[None, :], R),
        1, 2)                                                  # (S, R, W)
    bmask = tv[:, None, :] & (
        jnp.arange(R, dtype=jnp.int32)[None, :, None]
        < r_tab[:, None, None])
    Bp = jnp.where(bmask, Bp, 0.0)
    return T, Bp


def _panel_positions(cp, r_tab, tv, R, scratch):
    """Rebuild the (S, W, W) top-triangle and (S, R, W) below-block
    position arrays from per-panel col_ptr vectors (affine in both
    ranks)."""
    S, W = cp.shape
    il = jnp.arange(W, dtype=jnp.int32)
    rr = jnp.arange(R, dtype=jnp.int32)
    w = tv.sum(axis=-1).astype(jnp.int32)                    # (S,)
    tri_mask = tv[:, :, None] & tv[:, None, :] & (
        il[:, None] >= il[None, :])[None]
    tp = jnp.where(tri_mask, cp[:, None, :] + (il[:, None] - il[None, :]),
                   scratch)
    bp_mask = tv[:, None, :] & (rr[None, :, None] < r_tab[:, None, None])
    bp = jnp.where(bp_mask,
                   cp[:, None, :] + (w[:, None, None] - il[None, None, :])
                   + rr[None, :, None],
                   scratch)
    return tp, bp


def supernode_stats(a: CSR, *, relax: int = 0):
    """Cheap partition-only analysis — enough to decide supernodal-vs-scalar
    dispatch WITHOUT building the (much more expensive) full schedule.
    Returns ``(avg_panel_width, parts)``; memoised per (matrix, relax).
    ``parts`` carries everything :func:`analyze_supernodal` needs:
    (parent, col_ptr, csc_rows, sid, c0, c1)."""
    check(a.rows == a.cols, NonSquareMatrix, f"needs square, got {a.dims}")
    cache = getattr(a, "_sn_stats_cache", None)
    if cache is not None and cache[0] == relax:
        return cache[1], cache[2]
    n = a.rows
    parent, l_indptr, l_indices = symbolic.chol_symbolic_csr(a)

    # CSC pattern, diagonal first per column.
    l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
    order = np.lexsort((l_rows, l_indices))
    csc_rows = l_rows[order]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr[1:], l_indices[order], 1)
    col_ptr = np.cumsum(col_ptr)

    sid = symbolic.supernodes(col_ptr, csc_rows, parent, relax=relax)
    nsn = int(sid.max()) + 1 if n else 0
    # sid is non-decreasing: supernode column ranges by binary search
    c0 = np.searchsorted(sid, np.arange(nsn))
    c1 = np.searchsorted(sid, np.arange(nsn), side="right")
    width = n / max(nsn, 1)
    parts = (parent, col_ptr, csc_rows, sid, c0, c1)
    object.__setattr__(a, "_sn_stats_cache", (relax, width, parts))
    return width, parts


def analyze_supernodal(a: CSR, *, relax: int = 0) -> SupernodalSchedule:
    """``relax > 0`` amalgamates near-identical columns into wider panels by
    EXPANDING the factor pattern (explicit zeros): every column of a
    supernode takes the union row structure, restoring the fundamental
    property by construction. More padding, fewer and wider dense panels.

    Construction cost: with the (possibly expanded) pattern satisfying the
    fundamental property, every column of a panel is exactly
    ``[tail | below]`` sorted ascending, so all gather/panel positions are
    AFFINE in (column, rank) — no searches. Only the update scatter needs a
    ``searchsorted`` into the target panel's below rows. Symbolic results
    are shared with the scatter-list path via
    ``symbolic.chol_symbolic_csr``; partition/expansion run in the native
    runtime (csparse.cpp)."""
    _, parts = supernode_stats(a, relax=relax)
    parent, col_ptr, csc_rows, sid, c0, c1 = parts
    n = a.rows
    nsn = c0.shape[0]
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))

    if relax > 0:
        # native pattern expansion (explicit zeros restore the fundamental
        # property); sid/c0/c1 are unchanged by construction
        col_ptr, csc_rows = symbolic.expand_pattern(
            n, col_ptr, csc_rows, c0, c1)
    csc_cols = np.repeat(np.arange(n), np.diff(col_ptr))
    nnz_l = csc_rows.shape[0]
    csc_keys = csc_cols * n + csc_rows

    # A scatter positions (lower incl diagonal) — AFTER any pattern
    # expansion so positions index the final value array.
    keep = indices <= rows
    # indices may be int32 from CSR storage: the key must widen BEFORE the
    # multiply (int32*n overflows at n > 65535 under NumPy-2 promotion).
    a_src_pos = np.searchsorted(
        csc_keys, indices[keep].astype(np.int64) * n + rows[keep])
    a_vals_idx = np.nonzero(keep)[0]

    # supernode etree + fan-in levels
    last_parent = parent[c1 - 1] if nsn else np.empty(0, dtype=np.int64)
    sparent = np.where(last_parent != -1,
                       sid[np.clip(last_parent, 0, max(n - 1, 0))], -1)
    slevel = np.zeros(nsn, dtype=np.int64)
    for s in range(nsn):       # sparent[s] > s: one ascending pass suffices
        p = sparent[s]
        if p != -1:
            slevel[p] = max(slevel[p], slevel[s] + 1)
    nlev = int(slevel.max()) + 1 if nsn else 1
    scratch = nnz_l
    w_of = (c1 - c0).astype(np.int64)

    # ---------------- update lists, grouped by target level ----------------
    # Update gather positions are affine: within source panel d, column
    # c's rows are [c..hi) ++ below_d, so pos(below_d[r], c) =
    # col_ptr[c] + (hi - c) + r.
    updates: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(nlev)]
    for d in range(nsn):
        last = int(c1[d]) - 1
        rd = csc_rows[col_ptr[last] + 1: col_ptr[last + 1]]
        if rd.size == 0:
            continue
        tgt = sid[rd]
        bounds = np.nonzero(np.diff(tgt))[0] + 1
        g0s = np.concatenate([[0], bounds])
        g1s = np.concatenate([bounds, [rd.size]])
        for g0, g1 in zip(g0s, g1s):
            s = int(tgt[g0])
            updates[int(slevel[s])].append((d, int(g0), int(g1), s))

    # ---- bucket each level's updates by shape class (padding bound) ----
    # Under ND orderings a level mixes many leaf updates with a few
    # separator updates 10-100x their size; one padded (U, maxI, maxJ, W)
    # stack then charges every small update the big updates' dims — in
    # table memory, upload bytes, AND einsum flops (padding multiplies
    # real zeros). Bucket updates by the pow4 class of their I-dim into at
    # most _MAX_BUCKETS stacks per level; every bucket except the one
    # carrying the level's panel finalisation becomes an update-only
    # pseudo-level (dummy 1x1 panel tables aimed at the scratch slot, which
    # the numeric step re-zeroes anyway).
    def _upd_dims(up):
        d, g0, g1, _ = up
        last = int(c1[d]) - 1
        nrd = int(col_ptr[last + 1] - col_ptr[last] - 1)
        return nrd - g0, g1 - g0, int(w_of[d])

    def _stack_volume(ups):
        if not ups:
            return 0
        dims = [_upd_dims(up) for up in ups]
        mi = max(d[0] for d in dims)
        mj = max(d[1] for d in dims)
        mw = max(d[2] for d in dims)
        return len(ups) * (mi * mw + mj * mw + mi * mj)

    entries: List[Tuple[list, int]] = []   # (updates, panel level | -1)
    for lv in range(nlev):
        ups = updates[lv]
        buckets: dict = {}
        for up in ups:
            i_dim = max(_upd_dims(up)[0], 1)
            cls = 0
            while (1 << (2 * cls)) < i_dim:   # classes at 1, 4, 16, 64, …
                cls += 1
            buckets.setdefault(cls, []).append(up)
        classes = sorted(buckets)
        while len(classes) > _MAX_BUCKETS:    # merge the two smallest
            buckets[classes[1]] = buckets.pop(classes[0]) + buckets[classes[1]]
            classes = sorted(buckets)
        # split only when the single stack genuinely over-pads: bucketing a
        # homogeneous level just fragments the same-shape groups (RCM
        # chains measured 233 → 1075 groups, a compile-time regression)
        v1 = _stack_volume(ups)
        v2 = sum(_stack_volume(buckets[c]) for c in classes)
        if len(classes) <= 1 or v1 <= 2 * v2 or v1 < _BUCKET_MIN_VOLUME:
            entries.append((ups, lv))
        else:
            for ci, cls in enumerate(classes):
                entries.append((buckets[cls],
                                lv if ci == len(classes) - 1 else -1))

    # Compact per-update vectors only (O(I+J+W) per update, not O(I·(J+W))
    # — the full position arrays are rebuilt in-register on device by
    # _upd_positions; measured 3 GB → tens of MB at n=36k).
    upd_base, upd_meta = [], []
    upd_irows, upd_ibelow, upd_jrows, upd_jcp = [], [], [], []
    tgt_cp, tgt_nrows, tgt_w, upd_seg = [], [], [], []
    delta_rmax, use_delta, use_window = [], [], []
    for ei, (ups, _panel_lv) in enumerate(entries):
        # Sort updates by target panel: the delta formulation's segment
        # merge wants runs, and update order within a level is arbitrary
        # (all sources live in earlier levels).
        ups = sorted(ups, key=lambda up: up[3])
        entries[ei] = (ups, _panel_lv)
        U = _q(max(len(ups), 1))
        maxI = maxJ = maxWl = 1
        for d, g0, g1, s in ups:
            last = int(c1[d]) - 1
            nrd = int(col_ptr[last + 1] - col_ptr[last] - 1)
            maxI = max(maxI, nrd - g0)
            maxJ = max(maxJ, g1 - g0)
            maxWl = max(maxWl, int(w_of[d]))
        maxI, maxJ, maxWl = _q(maxI), _q(maxJ), _q(maxWl)
        baset = np.full((U, maxWl), scratch, dtype=np.int64)
        metat = np.zeros((U, 4), dtype=np.int64)
        irt = np.full((U, maxI), n, dtype=np.int64)
        ibt = np.zeros((U, maxI), dtype=np.int64)
        jrt = np.full((U, maxJ), n, dtype=np.int64)
        jct = np.full((U, maxJ), scratch, dtype=np.int64)
        for u, (d, g0, g1, s) in enumerate(ups):
            lo, hi = int(c0[d]), int(c1[d])
            wd = hi - lo
            last = hi - 1
            rd = csc_rows[col_ptr[last] + 1: col_ptr[last + 1]]
            ni, nj = rd.size - g0, g1 - g0
            cols_d = np.arange(lo, hi)
            baset[u, :wd] = col_ptr[cols_d] + (hi - cols_d) + g0
            # scatter metadata: pos(i, j) for i >= j; i in rd[g0:], j in
            # rd[g0:g1] (j are columns of target panel s). Column j's rows
            # are [j..hi_s) ++ below_s → in-panel targets are affine,
            # below-panel targets need one searchsorted into below_s.
            hi_s = int(c1[s])
            last_s = hi_s - 1
            below_s = csc_rows[col_ptr[last_s] + 1: col_ptr[last_s + 1]]
            i_rows = rd[g0:]
            j_rows = rd[g0:g1]
            metat[u] = (ni, nj, hi_s, int(c0[s]))
            irt[u, :ni] = i_rows
            ibt[u, :ni] = np.searchsorted(below_s, i_rows)
            jrt[u, :nj] = j_rows
            jct[u, :nj] = col_ptr[j_rows]
        upd_base.append(baset.astype(np.int32))
        upd_meta.append(metat.astype(np.int32))
        # Row ids and below-ranks are < n (sentinel exactly n), so they fit
        # uint16 whenever n does — 70% of the schedule bytes at n=36k
        # (upload AND per-level memory reads) halve; _upd_positions widens in
        # register. base/jcp index the nnz_l-sized value array: int32.
        row_dtype = np.uint16 if n <= 0xFFFF else np.int32
        upd_irows.append(irt.astype(row_dtype))
        upd_ibelow.append(ibt.astype(row_dtype))
        upd_jrows.append(jrt.astype(row_dtype))
        upd_jcp.append(jct.astype(np.int32))

        # -------- target-panel tables (delta-scatter formulation) --------
        # The level's distinct update targets; each target panel's storage
        # is one contiguous dense trapezoid whose (row rank r, col rank w)
        # element sits at col_ptr[c0_s + w] + (r - w) — affine for tail AND
        # below rows. Embedding every update into its target's rect via
        # one-hot matmuls and scattering the merged rects replaces the
        # U·I·J element scatter with St·nrows·Wt (see _level_step).
        ts = sorted({s for _, _, _, s in ups})
        St = _q(max(len(ts), 1))
        Wt = _q(max((int(w_of[s]) for s in ts), default=1))
        nrows_of = {}
        for s in ts:
            hi_s = int(c1[s])
            below_ct = int(col_ptr[hi_s] - col_ptr[hi_s - 1] - 1)
            nrows_of[s] = int(w_of[s]) + below_ct
        rmax_d = _q(max(nrows_of.values(), default=1))
        tcp = np.full((St, Wt), scratch, dtype=np.int64)
        tnr = np.zeros((St,), dtype=np.int64)
        twd = np.zeros((St,), dtype=np.int64)
        for k, s in enumerate(ts):
            lo_s, hi_s = int(c0[s]), int(c1[s])
            ws = hi_s - lo_s
            tcp[k, :ws] = col_ptr[lo_s:hi_s]
            tnr[k] = nrows_of[s]
            twd[k] = ws
        rank_of = {s: k for k, s in enumerate(ts)}
        segt = np.zeros((U,), dtype=np.int64)
        for u, (_, _, _, s) in enumerate(ups):
            segt[u] = rank_of[s]
        tgt_cp.append(tcp.astype(np.int32))
        tgt_nrows.append(tnr.astype(np.int32))
        tgt_w.append(twd.astype(np.int32))
        upd_seg.append(segt.astype(np.int32))
        delta_rmax.append(max(rmax_d, 1))
        elem_scatter = U * maxI * maxJ
        rect_scatter = St * rmax_d * Wt
        # Memory guard over every delta-formulation intermediate: the
        # merge temps d (U·I·Wt) / e (U·Rd·Wt) and the merged rects
        # p (St·Rd·Wt) can each reach multi-GB at wide-target levels.
        delta_elems = max(U * maxI * rmax_d, U * maxI * Wt,
                          U * rmax_d * Wt, St * rmax_d * Wt)
        rowmap_mb = delta_elems * 4 / 2**20
        # Scatter rule: both formulations pay per scattered element and
        # the one-hot merge einsums are small beside them, so the rect
        # scatter is taken when it scatters fewer elements, with a margin
        # for the merge temps' memory traffic.
        use_delta.append(bool(ups) and rect_scatter * 1.2 < elem_scatter
                         and rowmap_mb < 1024)
        # Read rule (config supernodal_gather="auto"): one window read
        # (vmapped dynamic_slice) replaces a run of element gathers, so
        # windows are taken where the runs are long.
        use_window.append(bool(ups) and maxI + maxJ >= 144)

    # ------------- panel tables (compact: col_ptr vectors) -------------
    panel_cp, panel_r, top_valid = [], [], []
    for _ups, lv in entries:
        if lv == -1:
            # update-only pseudo-level: dummy panels into the scratch slot
            panel_cp.append(np.full((1, 1), scratch, dtype=np.int32))
            panel_r.append(np.zeros((1,), dtype=np.int32))
            top_valid.append(np.zeros((1, 1), dtype=bool))
            continue
        sns = np.nonzero(slevel == lv)[0]
        S = _q(max(sns.size, 1))
        Wl = _q(max((int(w_of[s]) for s in sns), default=1))
        cp = np.full((S, Wl), scratch, dtype=np.int64)
        rt = np.zeros((S,), dtype=np.int64)
        tv = np.zeros((S, Wl), dtype=bool)
        for k, s in enumerate(sns):
            lo, hi = int(c0[s]), int(c1[s])
            w = hi - lo
            tv[k, :w] = True
            cp[k, :w] = col_ptr[lo:hi]
            rt[k] = int(col_ptr[hi] - col_ptr[hi - 1] - 1)
        panel_cp.append(cp.astype(np.int32))
        panel_r.append(rt.astype(np.int32))
        top_valid.append(tv)

    # Group consecutive levels whose table shapes AND max below-row counts
    # all match and stack them (leading axis g): the numeric phase scans
    # within a group, so chain-shaped schedules compile O(#groups), not
    # O(#levels). panel_r's MAX is a shape (the rebuilt below-block's R
    # axis), so it must match within a group.
    per_level = [upd_base, upd_meta, upd_irows, upd_ibelow, upd_jrows,
                 upd_jcp, panel_cp, panel_r, top_valid,
                 tgt_cp, tgt_nrows, tgt_w, upd_seg]
    rmax = [_q(int(r.max()) if r.size else 1) for r in panel_r]
    grouped = [[] for _ in per_level]
    _group_starts = []
    nent = len(entries)
    lv = 0
    while lv < nent:
        _group_starts.append(lv)
        j = lv + 1
        while (j < nent and rmax[j] == rmax[lv]
               and delta_rmax[j] == delta_rmax[lv]
               and use_delta[j] == use_delta[lv]
               and all(t[j].shape == t[lv].shape for t in per_level)):
            j += 1
        for gl, t in zip(grouped, per_level):
            gl.append(np.stack(t[lv:j]))
        lv = j

    # ---- pack every table into three flat buffers (3 uploads total) ----
    # Per-table uploads would be ~13 x n_groups transfers; the device
    # never needs the tables as
    # separate arrays — _group_tabs re-slices them at trace time from
    # these, at static offsets (free inside the compiled programs).
    _BUF_DTYPES = (np.dtype(np.int32), np.dtype(np.uint16),
                   np.dtype(np.bool_))
    chunks = [[] for _ in _BUF_DTYPES]
    offs = [0, 0, 0]
    layout = []
    for gi in range(len(grouped[0])):
        lay = []
        for ti in range(len(grouped)):
            t = grouped[ti][gi]
            bid = _BUF_DTYPES.index(np.dtype(t.dtype))
            chunks[bid].append(t.ravel())
            lay.append((bid, offs[bid], tuple(int(s) for s in t.shape)))
            offs[bid] += t.size
        layout.append(tuple(lay))

    def _flat(bid):
        if chunks[bid]:
            return jnp.asarray(np.concatenate(chunks[bid]))
        return jnp.zeros((0,), dtype=_BUF_DTYPES[bid])

    sched = SupernodalSchedule(
        a_src_pos=jnp.asarray(a_src_pos.astype(np.int32)),
        a_vals_idx=jnp.asarray(a_vals_idx.astype(np.int32)),
        flat_i32=_flat(0),
        flat_u16=_flat(1),
        flat_bool=_flat(2),
        layout=tuple(layout),
        panel_rmax=tuple(max(rmax[lv], 1)
                         for lv in _group_starts),
        delta_rmax=tuple(delta_rmax[lv] for lv in _group_starts),
        use_delta=tuple(use_delta[lv] for lv in _group_starts),
        use_window=tuple(use_window[lv] for lv in _group_starts),
        nnz_l=nnz_l,
        n=n,
    )
    # host-only metadata (not pytree fields)
    object.__setattr__(sched, "_host_tabs",
                       tuple(tuple(gl) for gl in grouped))
    object.__setattr__(sched, "avg_panel_width", n / max(nsn, 1))
    object.__setattr__(sched, "l_pattern", (csc_rows, csc_cols))
    # panel partition and etree levels, for models.supernodal_solve
    object.__setattr__(sched, "panel_parts",
                       (col_ptr, csc_rows, c0, c1, slevel))
    return sched


def _delta_scatter(lvals, u3, meta, irows, ibelow, jrows,
                   tcp, tnr, twd, seg, Rd: int, scratch: int):
    """Apply a level's updates as TARGET-PANEL RECT deltas instead of
    per-element scatters. Each target panel's storage is one contiguous
    trapezoid whose (row rank r, col rank w) element sits at
    ``col_ptr[c0_s + w] + (r - w)`` for tail AND below rows, so:

    * embed every update into its target's (Rd, Wt) rect with two one-hot
      matmuls (row rank = ``ir - c0_s`` in the tail, ``W_s + ibelow``
      below; col rank = ``jr - c0_s``) — values copied exactly (one-hot
      rows sum a single product);
    * merge updates sharing a target with a one-hot segment matmul;
    * scatter the St merged rects at in-register affine positions —
      ``St·Rd·Wt`` scatter elements instead of ``U·I·J``.

    Out-of-range ranks (padding lanes, upper wedge) fall out of the
    one-hot support or land on ``scratch``, which the caller re-zeroes."""
    Ucnt, I, J = u3.shape
    St, Wt = tcp.shape
    prec = jax.lax.Precision.HIGHEST
    irows = irows.astype(jnp.int32)
    ibelow = ibelow.astype(jnp.int32)
    jrows = jrows.astype(jnp.int32)
    ni, nj, his, c0s = (meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3])
    ii = jnp.arange(I, dtype=jnp.int32)
    jj = jnp.arange(J, dtype=jnp.int32)
    ws = his - c0s                                           # (U,)
    ri = jnp.where(irows < his[:, None], irows - c0s[:, None],
                   ws[:, None] + ibelow)
    ri = jnp.where(ii[None, :] < ni[:, None], ri, Rd)        # (U, I)
    rj = jnp.where(jj[None, :] < nj[:, None],
                   jrows - c0s[:, None], Wt)                 # (U, J)

    def merge_chunk(u3c, ric, rjc, sgc):
        rowmap = (ric[:, :, None]
                  == jnp.arange(Rd, dtype=jnp.int32)).astype(u3.dtype)
        colmap = (rjc[:, :, None]
                  == jnp.arange(Wt, dtype=jnp.int32)).astype(u3.dtype)
        segmap = (sgc[None, :].astype(jnp.int32)
                  == jnp.arange(St, dtype=jnp.int32)[:, None]
                  ).astype(u3.dtype)
        d = jnp.einsum("uij,ujw->uiw", u3c, colmap, precision=prec)
        e = jnp.einsum("uir,uiw->urw", rowmap, d, precision=prec)
        return jnp.einsum("su,urw->srw", segmap, e, precision=prec)

    # Bound the merge temps (rowmap (U,I,Rd) / d (U,I,Wt) / e (U,Rd,Wt))
    # by scanning U-chunks when the level is too big to merge at once
    # (a top separator level with U~1.8k, Rd=Wt=1293 has a 12 GB
    # unchunked e-temp).
    per_u = max(I * Rd, I * Wt, Rd * Wt, I * J)
    uc = max(min(_MERGE_CHUNK_ELEMS // max(per_u, 1), Ucnt), 1)
    nc = -(-Ucnt // uc)
    if nc > 1:
        upad = nc * uc - Ucnt
        u3p = jnp.pad(u3, ((0, upad), (0, 0), (0, 0)))
        rip = jnp.pad(ri, ((0, upad), (0, 0)), constant_values=Rd)
        rjp = jnp.pad(rj, ((0, upad), (0, 0)), constant_values=Wt)
        sgp = jnp.pad(seg.astype(jnp.int32), (0, upad),
                      constant_values=St)
        chunks = (u3p.reshape(nc, uc, I, J), rip.reshape(nc, uc, I),
                  rjp.reshape(nc, uc, J), sgp.reshape(nc, uc))
        p, _ = jax.lax.scan(
            lambda acc, ops: (acc + merge_chunk(*ops), None),
            jnp.zeros((St, Rd, Wt), u3.dtype), chunks)
    else:
        p = merge_chunk(u3, ri, rj, seg.astype(jnp.int32))
    rr = jnp.arange(Rd, dtype=jnp.int32)[None, :, None]
    wwt = jnp.arange(Wt, dtype=jnp.int32)[None, None, :]
    mask = ((wwt < twd[:, None, None]) & (rr >= wwt)
            & (rr < tnr[:, None, None]))
    pos = jnp.where(mask, tcp[:, None, :] + rr - wwt, scratch)
    return lvals.at[pos].add(-p)


def _level_step(lvals, tabs, R: int, Rd: int, scratch: int,
                window: bool = False, smode: str = "element"):
    """One fan-in level: batched panel updates + panel finalisation.
    ``tabs`` holds the COMPACT per-level tables; the full position arrays
    are rebuilt in-register (integer work instead of 3 GB-scale table
    reads — see _upd_positions/_panel_positions). With ``window=True``
    the READS use one gather per contiguous run instead of per element
    (U·W + S·W·2 windows vs U·(I+J)·W + S·W·(W+R) elements); ``smode``
    ("element" or "delta", the per-level choice under config
    ``supernodal_scatter``) routes the update scatter through
    :func:`_delta_scatter` instead of per-element positions."""
    (base, meta, irows, ibelow, jrows, jcp, cp, r_tab, tv,
     tcp, tnr, twd, seg) = tabs
    I = irows.shape[1]
    J = jrows.shape[1]
    # 1) batched panel-outer-product updates
    if window:
        A, B = _upd_windows(lvals, base, meta, scratch, I, J)
    else:
        ga, gb, _ = _upd_positions(base, meta, irows, ibelow, jrows, jcp,
                                   scratch, build_scatter=False)
        A = lvals[ga]                          # (U, I, W)
        B = lvals[gb]                          # (U, J, W)
    U = jnp.einsum("uiw,ujw->uij", A, B,
                   precision=jax.lax.Precision.HIGHEST)
    if smode == "delta":
        lvals = _delta_scatter(lvals, U, meta, irows, ibelow, jrows,
                               tcp, tnr, twd, seg, Rd, scratch)
    else:
        _, _, sc = _upd_positions(base, meta, irows, ibelow, jrows, jcp,
                                  scratch, build_gathers=False)
        lvals = lvals.at[sc].add(-U)
    lvals = lvals.at[scratch].set(0.0)

    # 2) batched panel finalisation
    tp, bp = _panel_positions(cp, r_tab, tv, R, scratch)
    if window:
        T, Bp = _panel_windows(lvals, cp, tv, r_tab, R)
    else:
        T = lvals[tp]                          # (S, W, W) lower part
        Bp = lvals[bp]                         # (S, R, W)
    eye = jnp.eye(T.shape[-1], dtype=T.dtype)
    # make padded columns well-posed: unit diagonal, zero elsewhere
    Tsym = T + jnp.where(tv[:, :, None] & tv[:, None, :], 0.0, eye)
    with factor_precision():
        Lt = jnp.linalg.cholesky(
            Tsym + jnp.triu(jnp.swapaxes(Tsym, 1, 2), 1))
        # solve Bp_new·Ltᵀ = Bp → Bp_new = Bp·Lt^{-T}
        Bn = jax.scipy.linalg.solve_triangular(
            Lt, jnp.swapaxes(Bp, 1, 2), lower=True)
    Bn = jnp.swapaxes(Bn, 1, 2)
    lvals = lvals.at[tp].set(
        jnp.where(jnp.isfinite(Lt), jnp.tril(Lt), 0.0), mode="drop")
    lvals = lvals.at[bp].set(Bn, mode="drop")
    return lvals.at[scratch].set(0.0)


def _group_tabs(sched: SupernodalSchedule, gi: int):
    """Slice group ``gi``'s 13 tables out of the packed flat buffers.
    Offsets/shapes are static (``sched.layout``), so under a trace this is
    free slicing fused into the program — no transfers, no dispatches."""
    bufs = (sched.flat_i32, sched.flat_u16, sched.flat_bool)
    out = []
    for bid, off, shape in sched.layout[gi]:
        size = 1
        for s in shape:
            size *= s
        out.append(jax.lax.slice(bufs[bid], (off,),
                                 (off + size,)).reshape(shape))
    return tuple(out)


def _tab_shape(sched: SupernodalSchedule, gi: int, name: str):
    return sched.layout[gi][_TABLE_INDEX[name]][2]


def _win_pad(sched: SupernodalSchedule) -> int:
    """Zero padding past the scratch slot so window gathers never clamp
    into live data: the longest window any group issues."""
    pad = 1
    for gi in range(sched.n_groups):
        pad = max(pad, _tab_shape(sched, gi, "upd_irows")[2],
                  _tab_shape(sched, gi, "upd_jrows")[2],
                  _tab_shape(sched, gi, "panel_cp")[2],
                  sched.panel_rmax[gi])
    return pad


@partial(jax.jit, static_argnums=(2,))
def _init_lvals(sched: SupernodalSchedule, a_values: jax.Array,
                pad: int = 1) -> jax.Array:
    lvals = jnp.zeros(sched.nnz_l + pad, dtype=jnp.float32)
    return lvals.at[sched.a_src_pos].add(
        a_values[sched.a_vals_idx].astype(jnp.float32))


def _run_group(lvals, tabs, R: int, Rd: int, scratch: int,
               window: bool, smode: str):
    if tabs[0].shape[0] == 1:
        return _level_step(lvals, tuple(t[0] for t in tabs), R, Rd,
                           scratch, window, smode)
    lvals, _ = jax.lax.scan(
        lambda lv, t, _R=R, _Rd=Rd: (
            _level_step(lv, t, _R, _Rd, scratch, window, smode), None),
        lvals, tabs)
    return lvals


def _run_groups(sched, lvals, gis, window, scatter_mode):
    scratch = sched.nnz_l
    for gi in gis:
        lvals = _run_group(lvals, _group_tabs(sched, gi),
                           sched.panel_rmax[gi], sched.delta_rmax[gi],
                           scratch, _group_window(sched, gi, window),
                           _group_delta(sched, gi, scatter_mode))
    return lvals


@partial(jax.jit, static_argnums=(2, 3, 4),
         compiler_options=XLA_COMPILE_OPTIONS)
def _groups_chunk(sched, lvals, gis, window, scatter_mode):
    """One device program covering a bounded slice of the group schedule.
    ``gis`` (static tuple of group indices) selects the slice; tables are
    sliced from the schedule's packed buffers at trace time."""
    return _run_groups(sched, lvals, gis, window, scatter_mode)


def _group_window(sched: SupernodalSchedule, gi: int, window: str) -> bool:
    """Resolve the per-group read formulation under config
    supernodal_gather: "window"/"element" force one path for every group;
    "auto" takes the host's per-group choice (``use_window``)."""
    if window == "auto":
        return bool(sched.use_window[gi])
    return window == "window"


def _group_delta(sched: SupernodalSchedule, gi: int, mode: str) -> str:
    """Resolve the per-group scatter formulation under config
    supernodal_scatter: "element"/"delta" force one path for every group;
    "auto" takes the host's per-group choice (``use_delta``)."""
    if mode == "auto":
        return "delta" if sched.use_delta[gi] else "element"
    return mode


def _lvals_pad(sched: SupernodalSchedule, window: str) -> int:
    uses_window = (any(sched.use_window) if window == "auto"
                   else window == "window")
    return 1 + (_win_pad(sched) if uses_window else 0)


@partial(jax.jit, static_argnums=(2, 3),
         compiler_options=XLA_COMPILE_OPTIONS)
def _factorize_supernodal_whole(sched: SupernodalSchedule,
                                a_values: jax.Array,
                                window: str = "element",
                                scatter_mode: str = "auto") -> jax.Array:
    lvals = _init_lvals(sched, a_values, _lvals_pad(sched, window))
    lvals = _run_groups(sched, lvals, range(sched.n_groups), window,
                        scatter_mode)
    return lvals[: sched.nnz_l]


def factorize_supernodal(sched: SupernodalSchedule,
                         a_values: jax.Array) -> jax.Array:
    """Numeric phase; returns L's flat CSC value array (length nnz_l).
    Unrolled over shape groups, ``lax.scan`` within each group — graph size
    O(#distinct level shapes). Schedules whose group count exceeds
    ``config.supernodal_groups_per_program`` are executed as a sequence of
    bounded device programs with ``lvals`` device-resident between them
    (dispatch pipelines asynchronously): the n=35937 3D-ND schedule's 263
    heterogeneous groups, compiled as ONE program, OOM-killed the XLA
    compile process — program size must stay bounded as n grows. Under an
    outer trace (e.g. a timing fori_loop) the whole-program form is used
    regardless, since a host-side chunk loop cannot run inside jit."""
    from ..utils.config import get_config

    cfg = get_config()
    window = cfg.supernodal_gather
    mode = cfg.supernodal_scatter
    n_g = sched.n_groups
    G = cfg.supernodal_groups_per_program
    if (not G or n_g <= G
            or isinstance(a_values, jax.core.Tracer)):
        return _factorize_supernodal_whole(sched, a_values, window, mode)
    lvals = _init_lvals(sched, a_values, _lvals_pad(sched, window))
    for c0 in range(0, n_g, G):
        gis = tuple(range(c0, min(c0 + G, n_g)))
        lvals = _groups_chunk(sched, lvals, gis, window, mode)
    return lvals[: sched.nnz_l]


def assemble_factor(a: CSR, lvals: np.ndarray,
                    sched: "SupernodalSchedule" = None) -> CSR:
    """Assemble L's CSR from the flat CSC values (host)."""
    if sched is not None and hasattr(sched, "l_pattern"):
        csc_rows, csc_cols = sched.l_pattern
    else:
        n = a.rows
        indptr, indices, _ = a.numpy()
        rows = np.repeat(np.arange(n), np.diff(indptr))
        low = indices < rows
        low_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(low_indptr[1:], rows[low], 1)
        low_indptr = np.cumsum(low_indptr)
        _, l_indptr, l_indices = symbolic.chol_symbolic(
            n, low_indptr, indices[low])
        l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
        order = np.lexsort((l_rows, l_indices))
        csc_rows, csc_cols = l_rows[order], l_indices[order]
    if len(lvals) != len(csc_rows):
        raise ValueError(
            f"assemble_factor: lvals length {len(lvals)} does not match the "
            f"factor pattern ({len(csc_rows)} entries) — with an expanded "
            f"(relax > 0) schedule, pass sched so the expanded pattern is "
            f"used")
    return CSR.from_coo_arrays((a.rows, a.rows), csc_rows, csc_cols, lvals,
                               sum_duplicates=False, drop_zeros=False)


def cholesky_supernodal(a: CSR) -> CSR:
    """End-to-end supernodal sparse Cholesky."""
    sched = analyze_supernodal(a)
    lvals = np.asarray(jax.device_get(factorize_supernodal(sched, a.values)))
    return assemble_factor(a, lvals, sched)
