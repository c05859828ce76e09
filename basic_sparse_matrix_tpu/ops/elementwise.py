"""Elementwise sparse algebra: add, sub, scalar multiply, reductions.

Reference counterparts:
* ``add_sparse`` / ``sub_sparse`` — per-row two-pointer sorted merges
  (``/root/reference/src/sparse.rs:484-599``). Three execution paths, all
  with static output capacity ``nnz_a + nnz_b`` (padding slots hold
  explicit zeros; ``CSR.compacted()`` restores exact-nnz storage):
  - *planned* (concrete operands): host union plan memoised per pattern
    pair; numeric phase is two gathers + add.
  - *key-space* (traced operands, rows·cols fits an accumulator):
    scatter-add into a flat cell space + static-size nonzero extraction.
  - *lexsort* (general): concat + lexsort + sorted-run segment-sum.
* ``mul_scalar`` (sparse.rs:645-652), ``sum_elements`` (sparse.rs:637-643),
  ``l2_norm`` (sparse.rs:678-680) — direct maps/reductions over the value
  array.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.errors import IncorrectDimensions, check
from .csr import CSR


def _merge(a: CSR, b: CSR, b_sign: int) -> CSR:
    n = a.stored + b.stored
    if n == 0:
        return CSR.empty(a.dims, dtype=a.dtype)

    rows = jnp.concatenate([a.row_ids(), b.row_ids()])
    cols = jnp.concatenate([a.indices, b.indices])
    vals = jnp.concatenate(
        [a.values, b.values if b_sign > 0 else -b.values]
    )
    # Two-key sort (row major, col minor) via lexsort: a combined
    # ``row*cols+col`` integer key overflows int32 for large shapes (x64 is
    # disabled by default in jax). A searchsorted interleave (the operands
    # are already sorted) lost to this: binary search lowers to ~21 serial
    # gather passes vs one fused sort (ARCHITECTURE.md).
    order = jnp.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    # Duplicate-coordinate merge on sorted entries: the first entry of each
    # equal run absorbs the run's sum; later entries of the run are zeroed in
    # place (their coordinates remain — harmless explicit zeros at static
    # capacity).
    first = jnp.concatenate(
        [jnp.ones(1, dtype=bool),
         (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])]
    )
    seg = jnp.cumsum(first) - 1  # dense run ids, sorted
    summed = jax.ops.segment_sum(vals, seg, num_segments=n,
                                 indices_are_sorted=True)
    vals = jnp.where(first, summed[seg], jnp.zeros_like(vals))

    counts = jnp.zeros(a.rows, dtype=jnp.int32).at[rows].add(1)
    indptr = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    return CSR(indptr=indptr, indices=cols, values=vals,
               rows=a.rows, cols=a.cols)


_merge_jit = jax.jit(_merge, static_argnums=2)


def _merge_keyspace(a: CSR, b: CSR, b_sign: int) -> CSR:
    """Dense key-space merge — the fast path when ``rows*cols`` fits a
    device accumulator. Scatter-adds both operands into a flat
    (rows·cols) accumulator, marks the union mask, and extracts the union
    coordinates ALREADY SORTED with one static-size ``nonzero`` (a cumsum)
    — replacing the two 2n-element sort passes of the lexsort merge. Output
    capacity is static ``nnz_a + nnz_b``; slots past the true union size
    are explicit zeros at coordinate (rows-1, cols-1), matching the
    lexsort merge's explicit-zero-padding semantics."""
    n = a.stored + b.stored
    ncell = a.rows * a.cols
    key_a = a.row_ids() * a.cols + a.indices
    key_b = b.row_ids() * b.cols + b.indices
    acc = jnp.zeros(ncell, dtype=jnp.result_type(a.values, b.values))
    acc = acc.at[key_a].add(a.values)
    acc = acc.at[key_b].add(b.values if b_sign > 0 else -b.values)
    mask = jnp.zeros(ncell, dtype=bool).at[key_a].set(True)
    mask = mask.at[key_b].set(True)
    keys = jnp.nonzero(mask, size=n, fill_value=ncell - 1)[0]
    fill = jnp.arange(n) >= jnp.sum(mask)
    vals = jnp.where(fill, 0, acc[keys]).astype(acc.dtype)
    rows = (keys // a.cols).astype(jnp.int32)
    cols = (keys % a.cols).astype(jnp.int32)
    counts = jnp.zeros(a.rows, dtype=jnp.int32).at[rows].add(1)
    indptr = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    return CSR(indptr=indptr, indices=cols, values=vals,
               rows=a.rows, cols=a.cols)


_merge_keyspace_jit = jax.jit(_merge_keyspace, static_argnums=2)


class _HasDuplicateCoords(Exception):
    """Operand stores duplicate coordinates — planned merge inapplicable."""


class _MergePlan:
    """Value-independent merge plan for a fixed (pattern_a, pattern_b) pair:
    the union coordinates (sorted, static capacity ``nnz_a + nnz_b`` with
    trailing explicit-zero padding at (rows-1, cols-1)) plus per-slot
    inverse gather maps into each operand's value vector. The numeric phase
    is two gathers + one add — the same symbolic/numeric split the
    factorizations use, applied to add/sub. Memoised on the left operand,
    keyed by the right operand's identity (weakref-validated)."""

    __slots__ = ("indptr", "indices", "gather_a", "gather_b", "n",
                 "chunked")

    def __init__(self, a: CSR, b: CSR):
        import numpy as np

        n = a.stored + b.stored
        ia, xa, _ = a.numpy()
        ib, xb, _ = b.numpy()
        ra = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(ia))
        rb = np.repeat(np.arange(b.rows, dtype=np.int64), np.diff(ib))
        ka = ra * a.cols + xa
        kb = rb * b.cols + xb
        # The inverse gather maps can carry at most ONE entry per operand
        # per output slot. Operands with duplicate stored coordinates (e.g.
        # the capacity-padded output of a previous merge) would silently
        # lose values — refuse, and let the dispatcher fall back to the
        # duplicate-safe key-space/lexsort merges.
        if (np.unique(ka).size != ka.size
                or np.unique(kb).size != kb.size):
            raise _HasDuplicateCoords()
        union = np.union1d(ka, kb)
        m = union.shape[0]
        keys = np.full(n, (a.rows - 1) * a.cols + (a.cols - 1),
                       dtype=np.int64)
        keys[:m] = union
        rows_o = keys // a.cols
        cols_o = keys % a.cols
        counts = np.zeros(a.rows, dtype=np.int64)
        np.add.at(counts, rows_o, 1)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        self.indptr = jnp.asarray(indptr.astype(np.int32))
        self.indices = jnp.asarray(cols_o.astype(np.int32))
        # Inverse maps: slot k takes operand entry gather_*[k] (sentinel =
        # one-past-end → a zero appended to the value vector). Each slot has
        # at most one contribution per operand, so the numeric phase is two
        # GATHERS + add — no scatter, no atomics.
        ga = np.full(n, a.stored, dtype=np.int64)
        ga[np.searchsorted(union, ka)] = np.arange(ka.shape[0])
        gb = np.full(n, b.stored, dtype=np.int64)
        gb[np.searchsorted(union, kb)] = np.arange(kb.shape[0])
        self.gather_a = jnp.asarray(ga.astype(np.int32))
        self.gather_b = jnp.asarray(gb.astype(np.int32))
        self.n = n
        self.chunked = None  # lazy _ChunkedMergePlan (config merge_numeric)


@partial(jax.jit, static_argnums=(3, 4))
def _merge_planned_vals(vals_a, vals_b, plan_gathers, n: int, b_sign: int):
    gather_a, gather_b = plan_gathers
    dtype = jnp.result_type(vals_a, vals_b)
    za = jnp.concatenate([vals_a.astype(dtype), jnp.zeros(1, dtype=dtype)])
    vb = vals_b if b_sign > 0 else -vals_b
    zb = jnp.concatenate([vb.astype(dtype), jnp.zeros(1, dtype=dtype)])
    return za[gather_a] + zb[gather_b]


# --- chunked numeric phase (issue-coalesced gathers) ---------------------
#
# The two inverse gathers above are SCALAR gathers: one per output slot
# (~2·n). Where random gathers are bound by their count rather than their
# bytes, fewer and wider gathers win. Because each inverse
# map is MONOTONE over its valid slots, all of an output chunk's w source
# elements live in at most two aligned w-chunks of the operand — so TWO
# row-gathers can serve w outputs. The within-row select uses a host-
# precomputed local index contracted against a one-hot on device (no scalar
# gathers). Issue count drops from 2n to 4n/w per operand pair.

MERGE_CHUNK_W = 32


def _build_chunked_map(ga: "np.ndarray", na: int, w: int):
    import numpy as np

    n = ga.shape[0]
    nch = -(-max(n, 1) // w)
    gap = np.full(nch * w, na, dtype=np.int64)
    gap[:n] = ga
    gam = gap.reshape(nch, w)
    valid = gam < na
    ca = -(-na // w) if na else 0
    big = np.iinfo(np.int64).max
    lo = np.where(valid, gam, big).min(axis=1)
    c0 = np.where(lo == big, ca, lo // w)  # empty chunk → zero-pad chunk
    local = gam - (c0 * w)[:, None]
    local = np.where(valid & (local >= 0) & (local < 2 * w), local, 2 * w)
    return c0.astype(np.int32), local.astype(np.int32)


class _ChunkedMergePlan:
    """Issue-coalesced twin of :class:`_MergePlan`'s numeric maps, built
    lazily from its inverse gathers (host-side, memoised on the plan)."""

    __slots__ = ("c_a", "l_a", "c_b", "l_b", "w")

    def __init__(self, plan: "_MergePlan", na: int, nb: int,
                 w: int = MERGE_CHUNK_W):
        import numpy as np

        ga = np.asarray(jax.device_get(plan.gather_a), dtype=np.int64)
        gb = np.asarray(jax.device_get(plan.gather_b), dtype=np.int64)
        ca0, la = _build_chunked_map(ga, na, w)
        cb0, lb = _build_chunked_map(gb, nb, w)
        self.c_a, self.l_a = jnp.asarray(ca0), jnp.asarray(la)
        self.c_b, self.l_b = jnp.asarray(cb0), jnp.asarray(lb)
        self.w = w


def _chunk_pad(vals, w):
    na = vals.shape[0]
    ca = -(-na // w) if na else 0
    pad = (ca + 2) * w - na
    return jnp.concatenate(
        [vals, jnp.zeros(pad, vals.dtype)]).reshape(ca + 2, w)


@partial(jax.jit, static_argnums=(3, 4, 5))
def _merge_chunked_vals(vals_a, vals_b, chunk_maps, n: int, b_sign: int,
                        w: int):
    c_a, l_a, c_b, l_b = chunk_maps
    dtype = jnp.result_type(vals_a, vals_b)

    def half(vals, c0, local):
        z = _chunk_pad(vals.astype(dtype), w)
        cand = jnp.concatenate([z[c0], z[c0 + 1]], axis=1)  # (nch, 2w)
        onehot = jax.nn.one_hot(local, 2 * w, dtype=dtype)  # (nch, w, 2w)
        return jnp.einsum("njt,nt->nj", onehot, cand,
                          precision=jax.lax.Precision.HIGHEST)

    out = half(vals_a, c_a, l_a)
    vb = vals_b if b_sign > 0 else -vals_b
    out = out + half(vb, c_b, l_b)
    return out.reshape(-1)[:n]


def _merge_planned(a: CSR, b: CSR, b_sign: int) -> CSR:
    import weakref

    plans = getattr(a, "_merge_plans", None)
    if plans is None:
        plans = []
        object.__setattr__(a, "_merge_plans", plans)
    plan = None
    for ref, p in plans:
        if ref() is b:
            plan = p
            break
    if plan is None:
        plan = _MergePlan(a, b)
        plans.append((weakref.ref(b), plan))
        del plans[:-4]  # bound the cache
    from ..utils.config import get_config

    if get_config().merge_numeric == "chunked":
        if plan.chunked is None:
            plan.chunked = _ChunkedMergePlan(plan, a.stored, b.stored)
        ch = plan.chunked
        vals = _merge_chunked_vals(
            a.values, b.values, (ch.c_a, ch.l_a, ch.c_b, ch.l_b),
            plan.n, b_sign, ch.w)
    else:
        vals = _merge_planned_vals(
            a.values, b.values, (plan.gather_a, plan.gather_b), plan.n,
            b_sign)
    return CSR(indptr=plan.indptr, indices=plan.indices, values=vals,
               rows=a.rows, cols=a.cols)

# Flat accumulator budget for the key-space merge (rows·cols·itemsize·~2).
KEYSPACE_BUDGET_BYTES = 1 << 28


def _use_keyspace(a: CSR, b: CSR) -> bool:
    if a.stored + b.stored == 0:
        return False
    ncell = a.rows * a.cols
    return ncell < 2**31 and 8 * ncell <= KEYSPACE_BUDGET_BYTES


def _dispatch_merge(a: CSR, b: CSR, b_sign: int) -> CSR:
    concrete = not (isinstance(a.values, jax.core.Tracer)
                    or isinstance(b.values, jax.core.Tracer))
    if concrete and a.stored + b.stored:
        # symbolic/numeric split: one host plan per pattern pair, then two
        # inverse gathers + add per call
        try:
            return _merge_planned(a, b, b_sign)
        except _HasDuplicateCoords:
            pass  # e.g. a previous merge's capacity-padded output
    if _use_keyspace(a, b):
        return _merge_keyspace_jit(a, b, b_sign)
    return _merge_jit(a, b, b_sign)


def add(a: CSR, b: CSR) -> CSR:
    """Sparse + sparse — reference ``add_sparse`` (sparse.rs:484-540).
    Concrete operands use the planned merge (host symbolic plan, memoised
    per pattern pair + one device scatter-add); traced operands fall back
    to the key-space merge (cell space permitting) or the lexsort merge."""
    check(a.shape == b.shape, IncorrectDimensions,
          f"add_sparse dims {a.dims} vs {b.dims}")
    return _dispatch_merge(a, b, 1)


def sub(a: CSR, b: CSR) -> CSR:
    """Sparse − sparse — reference ``sub_sparse`` (sparse.rs:542-599)."""
    check(a.shape == b.shape, IncorrectDimensions,
          f"sub_sparse dims {a.dims} vs {b.dims}")
    return _dispatch_merge(a, b, -1)


# Parity aliases.
add_sparse = add
sub_sparse = sub


@jax.jit
def mul_scalar(a: CSR, s) -> CSR:
    """Scale all stored values — reference ``mul_scalar``
    (sparse.rs:645-652)."""
    return CSR(indptr=a.indptr, indices=a.indices,
               values=a.values * jnp.asarray(s, dtype=a.dtype),
               rows=a.rows, cols=a.cols)


@jax.jit
def sum_elements(a: CSR):
    """Sum of stored values — reference ``sum_elements``
    (sparse.rs:637-643)."""
    return jnp.sum(a.values)


@jax.jit
def l2_norm(a: CSR):
    """Frobenius norm of stored values — reference ``l2_norm``
    (sparse.rs:678-680)."""
    return jnp.sqrt(jnp.sum(a.values.astype(jnp.float32) ** 2))
