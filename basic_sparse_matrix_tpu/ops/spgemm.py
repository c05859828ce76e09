"""SpGEMM (sparse × sparse).

Reference counterpart: ``mul_sparse`` (``/root/reference/src/
sparse.rs:601-635``) — transposes the RHS then runs a two-pointer merge dot
product over the *entire dense output space*, O(m·n·nnz/row). The reference
README lists sparse×sparse as an open TODO (README.md:23) yet ships and
benches this implementation.

Strategy: SpGEMM output sparsity is data-dependent, which fights
XLA's static-shape model. We provide:

* :func:`spgemm_dense` — jittable: gather rows of B^dense by A's column
  indices and segment-sum (i.e. SpMM against the densified RHS). At reference
  bench scale (1000×1000) this rides the gather/segment path and is
  orders of magnitude faster than merge loops.
* :func:`spgemm` — host wrapper returning a CSR with exact zeros dropped,
  matching the reference's ``val != default`` skip (sparse.rs:628-630).
* :func:`spgemm_bounded` — jittable sparse-output path with a static output
  capacity: expands A's entries against B's rows at a fixed per-row budget.
* :func:`spgemm_planned` — the scalable true-sparse path (host symbolic +
  device numeric): a vectorised Gustavson symbolic pass sizes the expansion
  by the ACTUAL per-entry row lengths (not ``nnz(A)·max_row(B)``, which
  explodes for skewed B), computes C's exact pattern, and memoises the
  plan; the numeric phase is one gather-multiply-scatter on device. Used
  when the densified RHS would not fit (large n). Expansions beyond
  ``EXPANSION_BUDGET`` fall back to contiguous row chunks planned and
  executed independently (:class:`_SpgemmChunkedPlan`) — no refusal.
  When the matched B rows are long (runs >= chunk width), the numeric
  phase can run ISSUE-COALESCED (config ``spgemm_numeric="chunked"``):
  source-order products from 4 aligned row gathers + one-hot select, then
  a single permutation gather to destination order — ~2x fewer scalar
  gather issues than the two-gather formulation (the planned-merge chunk
  trick of :mod:`ops.elementwise`, generalised).
  ``spgemm_numeric="rowgather"`` (r4) instead computes the expansion
  products from a padded B-ELL with one ROW gather per A entry — a free
  reshape when B's rows are uniform, an (nb, wB) element gather otherwise
  — keeping only the single destination permutation on the scalar-issue
  path (~E + nnz_a issues vs 2·E planned; the XLA formulation floor).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.errors import IncorrectDimensions, check
from .csr import CSR
from .spmm import spmm


@jax.jit
def spgemm_dense(a: CSR, b: CSR) -> jax.Array:
    """Dense product of two sparse operands (jittable)."""
    return spmm(a, b.todense())


DENSE_OUTPUT_BUDGET = 1 << 30  # bytes the densified RHS/output may occupy
EXPANSION_BUDGET = 1 << 27     # entries the bounded path may expand to


def spgemm(a: CSR, b: CSR) -> CSR:
    """Sparse × sparse → CSR — reference ``mul_sparse`` (sparse.rs:601-635).

    Dispatch: masked-dense (SpMM against the densified RHS) while the
    dense intermediates fit the budget — the fastest formulation at
    reference scale — else the planned true-sparse Gustavson path
    (:func:`spgemm_planned`), whose expansion is sized by the actual
    matched row lengths.

    Note: the reference performs *no* inner-dimension check (unlike
    ``mul_dense``); we add one, since silent garbage is not an API worth
    preserving.
    """
    check(a.cols == b.rows, IncorrectDimensions,
          f"mul_sparse: {a.dims} × {b.dims}")
    dense_bytes = 4 * max(b.rows * b.cols, a.rows * b.cols)
    if dense_bytes <= DENSE_OUTPUT_BUDGET:
        return CSR.from_dense(jax.device_get(spgemm_dense(a, b)))
    return spgemm_planned(a, b)


# Parity alias.
mul_sparse = spgemm


def spgemm_bounded(a: CSR, b: CSR, out_capacity: int) -> CSR:
    """Static-capacity sparse-output SpGEMM.

    Every stored entry ``A[i,k]`` contributes ``A[i,k] * B[k, :]`` to output
    row ``i``. We expand those contributions entry-by-entry against B's rows
    at B's max row length, then merge duplicates by (row, col) sort — the
    same machinery as :func:`elementwise.add`. ``out_capacity`` bounds the
    expanded entry count: ``nnz(A) * max_row_nnz(B)`` always suffices.

    Jittable for fixed ``out_capacity``; returns capacity-padded CSR (use
    ``.compacted()`` on host for exact storage).
    """
    check(a.cols == b.rows, IncorrectDimensions,
          f"spgemm_bounded: {a.dims} × {b.dims}")
    import numpy as np

    b_indptr = np.asarray(b.indptr)
    max_b_row = int(np.max(np.diff(b_indptr))) if b.stored else 0
    expanded = a.stored * max_b_row
    check(out_capacity >= expanded, IncorrectDimensions,
          f"out_capacity {out_capacity} < worst case {expanded}")
    return _spgemm_bounded_jit(a, b, max_b_row)


def _expand(a: CSR, b: CSR, max_b_row: int):
    # For each stored entry (i, k, v) of A, gather B's row k padded to
    # max_b_row: (cols, vals, valid-mask).
    starts = b.indptr[a.indices]                          # (nnz_a,)
    lens = b.indptr[a.indices + 1] - starts               # (nnz_a,)
    offs = jnp.arange(max_b_row, dtype=jnp.int32)          # (L,)
    gather_pos = jnp.clip(starts[:, None] + offs[None, :], 0,
                          max(b.stored - 1, 0))
    valid = offs[None, :] < lens[:, None]
    out_rows = jnp.broadcast_to(a.row_ids()[:, None], gather_pos.shape)
    out_cols = b.indices[gather_pos]
    out_vals = a.values[:, None] * b.values[gather_pos]
    out_vals = jnp.where(valid, out_vals, jnp.zeros_like(out_vals))
    # Invalid slots: park at (row, col) of the entry's own row, col 0, value 0
    # — harmless explicit zeros.
    out_cols = jnp.where(valid, out_cols, jnp.zeros_like(out_cols))
    return out_rows.ravel(), out_cols.ravel(), out_vals.ravel()


from functools import partial


@partial(jax.jit, static_argnums=2)
def _spgemm_bounded_jit(a: CSR, b: CSR, max_b_row: int) -> CSR:
    if max_b_row == 0 or a.stored == 0:
        return CSR.empty((a.rows, b.cols), dtype=a.dtype)
    rows, cols, vals = _expand(a, b, max_b_row)
    n = vals.shape[0]
    # lexsort (not a combined int key): row*cols+col overflows int32 at scale
    order = jnp.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    first = jnp.concatenate(
        [jnp.ones(1, dtype=bool),
         (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])]
    )
    seg = jnp.cumsum(first) - 1
    summed = jax.ops.segment_sum(vals, seg, num_segments=n,
                                 indices_are_sorted=True)
    vals = jnp.where(first, summed[seg], jnp.zeros_like(vals))
    counts = jnp.zeros(a.rows, dtype=jnp.int32).at[rows].add(1)
    indptr = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    return CSR(indptr=indptr, indices=cols, values=vals,
               rows=a.rows, cols=b.cols)


SPGEMM_CHUNK_W = 32


class _ExpansionOverBudget(Exception):
    """Actual Gustavson expansion exceeds EXPANSION_BUDGET — the caller
    should fall back to the row-chunked plan."""


class _SpgemmPlan:
    """Value-independent Gustavson plan for a fixed (pattern_a, pattern_b)
    pair: the exact output pattern of C = A·B plus flat
    (dst, src_a, src_b) contribution lists sized by the ACTUAL expansion
    (Σ over A entries of the matched B row length). The numeric phase is
    one gather-multiply-scatter-add on device. The symbolic pass is
    vectorised numpy (no Python per-entry loops)."""

    __slots__ = ("indptr", "indices", "dst", "src_a", "src_b", "nnz_c",
                 "rows", "cols", "expansion", "_host_indptr",
                 "_host_indices", "coal", "rowg", "_mt", "_mt_args")

    def __init__(self, a: CSR, b: CSR):
        ia, xa, _ = a.numpy()
        ib, xb, _ = b.numpy()
        self._build(ia, xa, a.rows, ib, xb, b.cols,
                    budget=EXPANSION_BUDGET)

    @property
    def mergetree(self):
        """Lazily built merge-tree numeric plan (None when inapplicable)."""
        if self._mt is False:
            mt = _SpgemmMergeTreePlan.build(self, *self._mt_args)
            if mt is not None and mt.sizes[-1] != self.nnz_c:
                mt = None  # defensive: pattern disagreement
            self._mt = mt
        return self._mt

    def _build(self, ia, xa, a_rows, ib, xb, b_cols, budget=None):
        import numpy as np

        nnz_a = xa.shape[0]
        ra = np.repeat(np.arange(a_rows, dtype=np.int64), np.diff(ia))
        b_len = np.diff(ib)
        lens = b_len[xa]                          # matched B-row lengths
        total = int(lens.sum())
        if budget is not None and total > budget:
            raise _ExpansionOverBudget(total)
        offsets = np.zeros(nnz_a + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        src_a = np.repeat(np.arange(nnz_a, dtype=np.int64), lens)
        within = np.arange(total, dtype=np.int64) - offsets[src_a]
        src_b = ib[xa[src_a]] + within
        out_row = ra[src_a]
        out_col = xb[src_b]
        key = out_row * b_cols + out_col
        pattern = np.unique(key)
        dst = np.searchsorted(pattern, key)
        nnz_c = pattern.shape[0]
        # Reorder the contribution lists by destination slot (host, once):
        # the numeric phase then reduces with a SORTED segment-sum instead
        # of a random scatter-add (sorted segment ids lower to a one-pass
        # reduction without atomics).
        order = np.argsort(dst, kind="stable")
        # Issue-coalesced numeric maps (config spgemm_numeric="chunked"):
        # built from the EXPANSION-order structure before it is discarded.
        self.coal = self._try_coalesce(xa, ib, lens, offsets, total, order)
        # Row-gather numeric maps (config spgemm_numeric="rowgather"):
        # built while `within` is still in scope.
        self.rowg = self._try_rowgather(xa, ib, b_len, within, src_a,
                                        order, total)
        dst, src_a, src_b = dst[order], src_a[order], src_b[order]
        counts = np.zeros(a_rows, dtype=np.int64)
        np.add.at(counts, pattern // b_cols, 1)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        self._host_indptr = indptr.astype(np.int64)
        self._host_indices = (pattern % b_cols).astype(np.int32)
        self.indptr = jnp.asarray(indptr.astype(np.int32))
        self.indices = jnp.asarray(self._host_indices)
        self.dst = jnp.asarray(dst.astype(np.int32))
        self.src_a = jnp.asarray(src_a.astype(np.int32))
        self.src_b = jnp.asarray(src_b.astype(np.int32))
        self.nnz_c = nnz_c
        self.rows, self.cols = a_rows, b_cols
        self.expansion = total
        self._mt = False           # not yet built (lazy)
        self._mt_args = (ia, xa, a_rows, ib, xb)
        return self

    def _try_rowgather(self, xa, ib, b_len, within, src_a, order, total,
                       overhead_cap: float = 4.0,
                       bytes_cap: int = 1 << 27):
        """Row-gather numeric maps (config ``spgemm_numeric="rowgather"``):
        compute the expansion products from a padded B-ELL with one ROW
        gather per A entry (``bell[xa]`` — nnz_a row issues fetching wB
        contiguous values each) instead of one scalar gather per expansion
        entry, then bring them to destination order with the single
        permutation gather. Scalar issues drop from 2·E (planned) to
        ~E + nnz_a row issues — the formulation floor for an exact-pattern
        XLA numeric phase. When B's rows are uniform, the ELL is a free
        reshape of ``vals_b``; otherwise a (nb, wB) element gather builds
        it (only worthwhile when nb·wB ≪ E). Returns None when the padded
        layouts blow the overhead/bytes budget (skewed B) — callers fall
        back to the standard maps."""
        import numpy as np

        E = int(total)
        nnz_a = xa.shape[0]
        if E < (1 << 14) or nnz_a == 0:
            return None
        wB = int(b_len.max()) if b_len.size else 0
        if wB == 0:
            return None
        nb = b_len.shape[0]
        uniform = int(b_len.min()) == wB
        padded = nnz_a * wB + (0 if uniform else nb * wB)
        if padded > overhead_cap * E or padded * 4 > bytes_cap \
                or nnz_a * wB >= (1 << 31):
            return None
        if uniform:
            ell_map = None
        else:
            s = np.arange(wB, dtype=np.int64)[None, :]
            ib64 = np.asarray(ib, dtype=np.int64)
            em = ib64[:-1, None] + s
            nnz_b = int(ib64[-1])
            em = np.where(s < b_len[:, None], em, nnz_b)  # -> appended zero
            ell_map = jnp.asarray(em.astype(np.int32))
        perm = (src_a * wB + within)[order]
        return dict(
            xa=jnp.asarray(np.asarray(xa).astype(np.int32)),
            ell_map=ell_map,
            perm=jnp.asarray(perm.astype(np.int32)),
            wB=wB,
            uniform=bool(uniform),
        )

    def _try_coalesce(self, xa, ib, lens, offsets, total,
                      order, w: int = SPGEMM_CHUNK_W):
        """Issue-coalesced numeric maps, generalising the planned-merge
        chunk trick (ops.elementwise._ChunkedMergePlan) to Gustavson
        expansion. In EXPANSION order the B-value sources are piecewise
        contiguous (one run per A entry, run e = ``vals_b[ib[xa[e]] :
        ib[xa[e]] + lens[e]]``), so when every w-slot chunk intersects at
        most TWO runs, four aligned w-row gathers (base chunk + successor,
        per run) plus a host-precomputed one-hot select serve all w slots.
        Scalar issues drop from 2·E (two random gathers) to ~E (the one
        destination-order permutation) + 4·E/w row issues. Returns None —
        falling back to the standard maps — when the operands' matched
        rows are too short for 2-run coverage or E is too small to care."""
        import numpy as np

        E = int(total)
        nnz_a = xa.shape[0]
        if E < (1 << 14) or nnz_a == 0:
            return None
        nch = -(-E // w)
        cw = np.arange(nch, dtype=np.int64) * w
        e1 = np.searchsorted(offsets, cw, side="right") - 1
        last = np.minimum(cw + w - 1, E - 1)
        eL = np.searchsorted(offsets, last, side="right") - 1
        if int(np.max(eL - e1)) > 1:
            return None
        e2 = np.minimum(e1 + 1, nnz_a - 1)
        ib64 = np.asarray(ib, dtype=np.int64)
        xa64 = np.asarray(xa, dtype=np.int64)
        # slots [cw, cw+boundary) read run e1 at source s1+j; the rest read
        # run e2, whose first in-chunk slot is offsets[e2] → source ib2.
        boundary = np.clip(offsets[e1 + 1] - cw, 0, w)
        s1 = ib64[xa64[e1]] + (cw - offsets[e1])
        ib2 = ib64[xa64[e2]]
        jj = np.arange(w, dtype=np.int64)
        loc = np.where(
            jj[None, :] < boundary[:, None],
            (s1 % w)[:, None] + jj[None, :],
            2 * w + (ib2 % w)[:, None] + (jj[None, :] - boundary[:, None]),
        )
        loc = np.where(cw[:, None] + jj[None, :] < E, loc, 4 * w)
        return dict(
            c1=jnp.asarray((s1 // w).astype(np.int32)),
            c2=jnp.asarray((ib2 // w).astype(np.int32)),
            e1=jnp.asarray(e1.astype(np.int32)),
            e2=jnp.asarray(e2.astype(np.int32)),
            boundary=jnp.asarray(boundary.astype(np.int32)),
            local=jnp.asarray(loc.astype(np.int32)),
            perm=jnp.asarray(order.astype(np.int32)),
            w=w,
        )


def _build_4run_map(g, n_src: int, w: int):
    """Coalesced gather maps for one side of a merge round: ``g`` maps each
    output slot to its source index in the round's input array (−1 = this
    side absent). Sources are monotone over valid slots and piecewise
    contiguous (runs = one input stream's contribution to one output
    stream), so when every w-slot output chunk intersects at most TWO runs,
    four aligned w-row gathers (base + successor per run) serve all w
    slots; the within-candidate position rides a host-precomputed uint8
    local index contracted against a one-hot on device. Returns ``None``
    when the 2-run condition fails (short streams — caller falls back)."""
    import numpy as np

    n = g.shape[0]
    nch = -(-max(n, 1) // w)
    gp = np.full(nch * w, -1, dtype=np.int64)
    gp[:n] = g
    gm = gp.reshape(nch, w)
    valid = gm >= 0
    big = np.iinfo(np.int64).max
    lo = np.where(valid, gm, big).min(axis=1)
    empty = lo == big
    c1 = np.where(empty, 0, lo // w)
    run1 = valid & (gm < (c1 * w + 2 * w)[:, None])
    rest = valid & ~run1
    lo2 = np.where(rest, gm, big).min(axis=1)
    c2 = np.where(lo2 == big, c1, lo2 // w)
    if np.any(rest & (gm >= (c2 * w + 2 * w)[:, None])):
        return None
    local = np.where(run1, gm - (c1 * w)[:, None],
                     np.where(rest, 2 * w + gm - (c2 * w)[:, None], 4 * w))
    return (c1.astype(np.int32), c2.astype(np.int32),
            local.astype(np.uint8 if 4 * w < 256 else np.int32))


class _SpgemmMergeTreePlan:
    """Permutation-free long-row numeric plan: SOURCE-order products from
    the issue-coalesced maps (no destination permutation), then
    ``ceil(log2(max nnz per A row))`` rounds of pairwise sorted-stream
    merging — each round a global application of the planned-merge chunk
    kernel (4 aligned row gathers + one-hot select per side, the ss_add
    formulation). Each A entry's contribution run is
    one sorted stream; round r merges stream pairs within each output row,
    summing duplicate columns, until one stream per row remains — which IS
    the row's C values in pattern order. Scalar issues drop from ~2E (two
    destination-order gathers) to ~8E/w row issues across all rounds; every
    other op is bandwidth-bound VPU work.

    Built lazily from a :class:`_SpgemmPlan` whose ``coal`` maps exist
    (matched B rows >= chunk width); ``build`` returns None when any round
    violates the 2-runs-per-chunk condition."""

    __slots__ = ("rounds", "sizes", "w")

    @staticmethod
    def build(plan: "_SpgemmPlan", ia, xa, a_rows, ib, xb,
              w: int = SPGEMM_CHUNK_W):
        import numpy as np

        if plan.coal is None:
            return None
        b_len = np.diff(ib)
        lens = b_len[xa]
        E = int(lens.sum())
        nnz_a = xa.shape[0]
        if E == 0 or nnz_a == 0:
            return None
        # source-order element state: stream id (= A entry), column
        stream = np.repeat(np.arange(nnz_a, dtype=np.int64), lens)
        offsets = np.zeros(nnz_a + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        within = np.arange(E, dtype=np.int64) - offsets[stream]
        col = xb[ib[xa[stream]] + within].astype(np.int64)
        # stream -> row, rank within row
        ra = np.repeat(np.arange(a_rows, dtype=np.int64), np.diff(ia))
        srow = ra
        srank = np.arange(nnz_a, dtype=np.int64) - ia[srow]
        max_k = int(np.max(np.diff(ia))) if nnz_a else 1
        rounds = []
        sizes = [E]
        while max_k > 1:
            # pair streams within each row: new stream id global by
            # (row, rank // 2); sides alternate
            new_rank = srank[stream] // 2
            side = (srank[stream] % 2).astype(np.int64)
            # global new-stream id must preserve (row-major, pair) order:
            nr_of_stream = srank // 2
            # unique (row, pair) pairs in order:
            pair_key = srow[stream] * (max_k + 1) + new_rank
            order = np.lexsort((side, col, pair_key))
            pk_s, col_s, side_s = (pair_key[order], col[order],
                                   side[order])
            first = np.ones(order.shape[0], dtype=bool)
            first[1:] = (pk_s[1:] != pk_s[:-1]) | (col_s[1:] != col_s[:-1])
            out_slot = np.cumsum(first) - 1
            n_out = int(out_slot[-1]) + 1 if order.size else 0
            ga = np.full(n_out, -1, dtype=np.int64)
            gb = np.full(n_out, -1, dtype=np.int64)
            is_b = side_s == 1
            ga[out_slot[~is_b]] = order[~is_b]
            gb[out_slot[is_b]] = order[is_b]
            ma = _build_4run_map(ga, sizes[-1], w)
            mb = _build_4run_map(gb, sizes[-1], w)
            if ma is None or mb is None:
                return None
            rounds.append((jnp.asarray(ma[0]), jnp.asarray(ma[1]),
                           jnp.asarray(ma[2]), jnp.asarray(mb[0]),
                           jnp.asarray(mb[1]), jnp.asarray(mb[2])))
            sizes.append(n_out)
            # next-round state
            keep = first
            col = col_s[keep]
            old_stream = stream[order][keep]
            # new global stream ids, contiguous by construction order
            new_key = pk_s[keep]
            stream_first = np.ones(new_key.shape[0], dtype=bool)
            stream_first[1:] = new_key[1:] != new_key[:-1]
            stream = np.cumsum(stream_first) - 1
            # new stream -> row, rank
            srow = srow[old_stream[stream_first]]
            srank = nr_of_stream[old_stream[stream_first]]
            max_k = -(-max_k // 2)
        self = _SpgemmMergeTreePlan.__new__(_SpgemmMergeTreePlan)
        self.rounds = tuple(rounds)
        self.sizes = tuple(sizes)
        self.w = w
        return self


@partial(jax.jit, static_argnums=(3, 4, 5))
def _spgemm_mergetree_vals(vals_a, vals_b, maps, sizes, nnz_c: int,
                           w: int):
    """Numeric phase of the merge-tree plan: coalesced source-order
    products, then the round kernels. ``maps`` = (coal source maps,
    per-round 4-run maps)."""
    (c1, c2, e1, e2, boundary, local), rounds = maps
    dtype = jnp.result_type(vals_a, vals_b)
    nb = vals_b.shape[0]
    cb = -(-nb // w) if nb else 0
    zpad = (cb + 2) * w - nb
    z = jnp.concatenate(
        [vals_b.astype(dtype), jnp.zeros(zpad, dtype)]).reshape(cb + 2, w)
    cand = jnp.concatenate(
        [z[c1], z[c1 + 1], z[c2], z[c2 + 1]], axis=1)       # (nch, 4w)
    onehot = jax.nn.one_hot(local, 4 * w, dtype=dtype)
    bsel = jnp.einsum("njt,nt->nj", onehot, cand,
                      precision=jax.lax.Precision.HIGHEST)
    va = jnp.where(
        jnp.arange(w, dtype=jnp.int32)[None, :] < boundary[:, None],
        vals_a.astype(dtype)[e1][:, None], vals_a.astype(dtype)[e2][:, None])
    p = (va * bsel).reshape(-1)[: sizes[0]]                 # source order

    def side(vals, cc1, cc2, loc):
        zz = jnp.concatenate(
            [vals, jnp.zeros((-(-vals.shape[0] // w) + 2) * w
                             - vals.shape[0], dtype)]).reshape(-1, w)
        cd = jnp.concatenate(
            [zz[cc1], zz[cc1 + 1], zz[cc2], zz[cc2 + 1]], axis=1)
        oh = jax.nn.one_hot(loc.astype(jnp.int32), 4 * w, dtype=dtype)
        return jnp.einsum("njt,nt->nj", oh, cd,
                          precision=jax.lax.Precision.HIGHEST)

    for r, (a1, a2, la, b1, b2, lb) in enumerate(rounds):
        p = (side(p, a1, a2, la)
             + side(p, b1, b2, lb)).reshape(-1)[: sizes[r + 1]]
    return p


@partial(jax.jit, static_argnums=(3, 4, 5))
def _spgemm_rowgather_vals(vals_a, vals_b, maps, nnz_c: int, wB: int,
                           uniform: bool):
    """Row-gather numeric phase (see _SpgemmPlan._try_rowgather): padded
    B-ELL products via one ROW gather per A entry, one permutation gather
    to destination order, sorted segment-sum."""
    xa, ell_map, perm, dst = maps
    dtype = jnp.result_type(vals_a, vals_b)
    if uniform:
        bell = vals_b.astype(dtype).reshape(-1, wB)
    else:
        vb = jnp.concatenate(
            [vals_b.astype(dtype), jnp.zeros(1, dtype)])
        bell = vb[ell_map]
    prod = vals_a.astype(dtype)[:, None] * bell[xa]      # (nnz_a, wB)
    # Barrier: without it XLA fuses the row gather INTO the permutation
    # gather, reconstituting a per-expansion-entry double scalar gather —
    # exactly the issue chain this formulation removes.
    prod = jax.lax.optimization_barrier(prod)
    contrib = prod.reshape(-1)[perm]
    return jax.ops.segment_sum(contrib, dst, num_segments=nnz_c,
                               indices_are_sorted=True)


@partial(jax.jit, static_argnums=(3,))
def _spgemm_planned_vals(vals_a, vals_b, plan_maps, nnz_c: int):
    dst, src_a, src_b = plan_maps
    prod = vals_a[src_a] * vals_b[src_b]
    # dst is sorted at plan time — a sorted segment-sum, not a scatter.
    return jax.ops.segment_sum(prod, dst, num_segments=nnz_c,
                               indices_are_sorted=True)


@partial(jax.jit, static_argnums=(4, 5))
def _spgemm_coalesced_vals(vals_a, vals_b, coal_maps, dst, nnz_c: int,
                           w: int):
    """Issue-coalesced numeric phase (see _SpgemmPlan._try_coalesce): the
    expansion product is computed in SOURCE order from 4 aligned row
    gathers per chunk + a one-hot select (fused by XLA into the gathers),
    then one permutation gather brings
    it to destination order for the sorted segment-sum."""
    c1, c2, e1, e2, boundary, local, perm = coal_maps
    dtype = jnp.result_type(vals_a, vals_b)
    nb = vals_b.shape[0]
    cb = -(-nb // w) if nb else 0
    zpad = (cb + 2) * w - nb
    z = jnp.concatenate(
        [vals_b.astype(dtype), jnp.zeros(zpad, dtype)]).reshape(cb + 2, w)
    cand = jnp.concatenate(
        [z[c1], z[c1 + 1], z[c2], z[c2 + 1]], axis=1)       # (nch, 4w)
    onehot = jax.nn.one_hot(local, 4 * w, dtype=dtype)       # (nch, w, 4w)
    bsel = jnp.einsum("njt,nt->nj", onehot, cand,
                      precision=jax.lax.Precision.HIGHEST)
    va = jnp.where(
        jnp.arange(w, dtype=jnp.int32)[None, :] < boundary[:, None],
        vals_a.astype(dtype)[e1][:, None], vals_a.astype(dtype)[e2][:, None])
    prod = (va * bsel).reshape(-1)[perm]
    return jax.ops.segment_sum(prod, dst, num_segments=nnz_c,
                               indices_are_sorted=True)


def _plan_numeric(plan: "_SpgemmPlan", vals_a, vals_b):
    """Run one plan's numeric phase on the configured path."""
    from ..utils.config import get_config

    coal = plan.coal
    if get_config().spgemm_numeric == "mergetree" and coal is not None:
        mt = plan.mergetree
        if mt is not None:
            maps = ((coal["c1"], coal["c2"], coal["e1"], coal["e2"],
                     coal["boundary"], coal["local"]),
                    mt.rounds)
            return _spgemm_mergetree_vals(vals_a, vals_b, maps, mt.sizes,
                                          plan.nnz_c, mt.w)
    numeric = get_config().spgemm_numeric
    # "auto": rowgather only in its winning regime — UNIFORM B
    # rows, where the B-ELL view is a free reshape and the issue count is
    # ~E + nnz_a. With ragged B the ELL build is an E-sized element
    # gather and rowgather loses to planned, so auto stays on planned
    # there.
    use_rowg = plan.rowg is not None and (
        numeric == "rowgather"
        or (numeric == "auto" and plan.rowg["uniform"]))
    if use_rowg:
        rg = plan.rowg
        return _spgemm_rowgather_vals(
            vals_a, vals_b, (rg["xa"], rg["ell_map"], rg["perm"], plan.dst),
            plan.nnz_c, rg["wB"], rg["uniform"])
    if coal is not None and get_config().spgemm_numeric == "chunked":
        maps = (coal["c1"], coal["c2"], coal["e1"], coal["e2"],
                coal["boundary"], coal["local"], coal["perm"])
        return _spgemm_coalesced_vals(vals_a, vals_b, maps, plan.dst,
                                      plan.nnz_c, coal["w"])
    return _spgemm_planned_vals(vals_a, vals_b,
                                (plan.dst, plan.src_a, plan.src_b),
                                plan.nnz_c)


class _SpgemmChunkedPlan:
    """Row-chunked Gustavson plan: when the full expansion exceeds
    ``EXPANSION_BUDGET``, partition A's rows into contiguous chunks whose
    per-chunk expansion fits the budget, build a :class:`_SpgemmPlan` per
    chunk, and run the numeric phases sequentially. Output rows are
    disjoint across chunks so the per-chunk CSR pieces concatenate exactly
    (indptr offset + indices/values concat). A single row whose own
    expansion exceeds the budget becomes a chunk by itself (memory guard
    relaxed rather than refusing — strictly better than the typed error).
    """

    __slots__ = ("chunks", "indptr", "indices", "nnz_c", "rows", "cols",
                 "expansion")

    def __init__(self, a: CSR, b: CSR):
        import numpy as np

        ia, xa, _ = a.numpy()
        ib, xb, _ = b.numpy()
        ia = np.asarray(ia, dtype=np.int64)
        b_len = np.diff(np.asarray(ib, dtype=np.int64))
        # cumulative expansion at each A-entry boundary → per-row prefix
        ce = np.zeros(xa.shape[0] + 1, dtype=np.int64)
        np.cumsum(b_len[xa], out=ce[1:])
        row_pref = ce[ia]                       # (rows+1,) expansion prefix
        self.expansion = int(row_pref[-1])

        # Greedy contiguous row chunks, each ≤ budget (single over-budget
        # rows stand alone).
        bounds = [0]
        r0 = 0
        while r0 < a.rows:
            r1 = int(np.searchsorted(row_pref,
                                     row_pref[r0] + EXPANSION_BUDGET,
                                     side="right")) - 1
            r1 = min(max(r1, r0 + 1), a.rows)
            bounds.append(r1)
            r0 = r1

        self.chunks = []
        indices_parts, indptr_parts = [], [np.zeros(1, dtype=np.int64)]
        nnz_off = 0
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            s, e = int(ia[r0]), int(ia[r1])
            sub_ip = (ia[r0:r1 + 1] - ia[r0]).astype(np.int64)
            p = _SpgemmPlan.__new__(_SpgemmPlan)
            p._build(sub_ip, xa[s:e], r1 - r0, ib, xb, b.cols)
            self.chunks.append((s, e, p))
            indices_parts.append(p._host_indices)
            indptr_parts.append(p._host_indptr[1:] + nnz_off)
            nnz_off += p.nnz_c
        self.nnz_c = nnz_off
        self.indptr = jnp.asarray(
            np.concatenate(indptr_parts).astype(np.int32))
        self.indices = jnp.asarray(
            np.concatenate(indices_parts).astype(np.int32))
        self.rows, self.cols = a.rows, b.cols

    def numeric(self, vals_a, vals_b):
        parts = [_plan_numeric(p, vals_a[s:e], vals_b)
                 for s, e, p in self.chunks]
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def spgemm_planned(a: CSR, b: CSR) -> CSR:
    """True sparse-output SpGEMM: host symbolic plan (memoised per pattern
    pair, weakref-validated) + one device gather-multiply-scatter. Exact
    output pattern — handles skewed B (e.g. one dense row) that the
    worst-case ``nnz(A)·max_row(B)`` bound of :func:`spgemm_bounded`
    cannot."""
    check(a.cols == b.rows, IncorrectDimensions,
          f"spgemm_planned: {a.dims} × {b.dims}")
    if a.stored == 0 or b.stored == 0:
        return CSR.empty((a.rows, b.cols), dtype=a.dtype)
    import weakref

    plans = getattr(a, "_spgemm_plans", None)
    if plans is None:
        plans = []
        object.__setattr__(a, "_spgemm_plans", plans)
    plan = None
    for ref, p in plans:
        if ref() is b:
            plan = p
            break
    if plan is None:
        try:
            plan = _SpgemmPlan(a, b)
        except _ExpansionOverBudget:
            # Actual expansion exceeds the single-shot budget: fall back to
            # contiguous row chunks planned/executed independently (output
            # rows are disjoint, so the pieces concatenate exactly).
            plan = _SpgemmChunkedPlan(a, b)
        plans.append((weakref.ref(b), plan))
        del plans[:-4]
    if isinstance(plan, _SpgemmChunkedPlan):
        vals = plan.numeric(a.values, b.values)
    else:
        vals = _plan_numeric(plan, a.values, b.values)
    return CSR(indptr=plan.indptr, indices=plan.indices, values=vals,
               rows=plan.rows, cols=plan.cols)
