"""Level-scheduled sparse Cholesky (symbolic + numeric split).

Reference counterpart: ``cholesky_decomp`` (``/root/reference/src/
sparse.rs:682-714``) — a scalar triple loop that rebuilds zero-filled factor
rows inside the innermost k-loop; it never exploits sparsity for compute.
This rebuild splits the factorization the standard way (SURVEY.md §7
step 4):

* **Symbolic phase** (native C++ runtime, ``runtime/symbolic``): elimination
  tree → fill pattern of L → fan-in levels. Columns whose etree descendants
  are complete are independent: ``level[j] = 1 + max(level(children))``, so
  every column of one level factorizes in parallel.
* **Numeric phase** (jit, device): a *scatter-list* formulation. Every
  left-looking update ``L[i,j] -= L[i,k]·L[j,k]`` is materialised on the host
  as an index triple ``(dst, src_a, src_b)`` into L's value array, grouped by
  the destination column's level. Per level the updates are one gather +
  multiply + ``segment_sum`` scatter-add; column finalisation (sqrt the
  diagonal, scale the column) is one more batched step. Wall-clock is
  O(n_levels) sequential steps; all flops within a level run batched on the
  VPU.

Because L[j,k] ≠ 0 implies k is a proper etree descendant of j, every source
column of an update sits in a *strictly earlier* level — the schedule is
correct by construction.

Scaling note: the scatter list stores 3 int32 per flop, so this formulation
targets the reference-scale and mid-size SPD regime (e.g. SuiteSparse
bcsstk/nos*). Very large factors want supernodal dense tiles (future round);
``cholesky_auto`` dispatches accordingly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.csr import CSR
from ..runtime import symbolic
from ..utils.errors import NonSquareMatrix, check


@dataclasses.dataclass(frozen=True)
class CholeskySchedule:
    """Static numeric-phase schedule (all host-precomputed, padded).

    The CSC pattern of L (``l_col_ptr``/``l_row_idx``, host numpy, diagonal
    first per column) is attached post-construction as plain attributes —
    it is host-only assembly metadata and must stay out of the pytree
    (numpy arrays are not hashable jit metadata).
    """

    # A-to-L scatter: position in L value array for each kept A entry.
    a_src_pos: jax.Array      # (nnz_lower_A,) int32 into L values
    a_vals_idx: jax.Array     # (nnz_lower_A,) int32 into A.values
    # Update triples grouped by level: upd[level] rows are (dst, src_a, src_b)
    upd_dst: jax.Array        # (nlev, max_upd) int32, pad → scratch slot
    upd_a: jax.Array          # (nlev, max_upd) int32
    upd_b: jax.Array          # (nlev, max_upd) int32
    # Column finalisation per level.
    col_pos: jax.Array        # (nlev, max_cols, max_len) int32 positions,
    #                           entry 0 = diagonal; pad → scratch slot
    nnz_l: int
    n: int


jax.tree_util.register_dataclass(
    CholeskySchedule,
    data_fields=["a_src_pos", "a_vals_idx", "upd_dst", "upd_a", "upd_b",
                 "col_pos"],
    meta_fields=["nnz_l", "n"],
)


def analyze(a: CSR, *, incomplete: bool = False) -> CholeskySchedule:
    """Symbolic phase. ``a`` must be square; only its lower triangle is read
    (symmetry assumed, like the reference).

    ``incomplete=True`` produces the **IC(0)** schedule: the factor pattern
    is restricted to A's own lower pattern (no fill), and update triples
    whose destination falls outside it are dropped — the standard
    incomplete-Cholesky preconditioner for :mod:`models.pcg`.
    """
    check(a.rows == a.cols, NonSquareMatrix, f"cholesky needs square {a.dims}")
    n = a.rows
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))

    if incomplete:
        # Strictly-lower pattern of A for the etree analysis.
        low = indices < rows
        low_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(low_indptr[1:], rows[low], 1)
        low_indptr = np.cumsum(low_indptr)
        parent = symbolic.etree(n, low_indptr, indices[low])
        # No-fill pattern: A's lower triangle plus an always-present diagonal.
        keep_low = indices <= rows
        pr = np.concatenate([rows[keep_low], np.arange(n)])
        pc = np.concatenate([indices[keep_low], np.arange(n)])
        pk = np.unique(pr * n + pc)
        l_rows_flat, l_indices = pk // n, pk % n
        l_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(l_indptr[1:], l_rows_flat, 1)
        l_indptr = np.cumsum(l_indptr)
    else:
        # shared, instance-memoised symbolic pass (one per matrix across
        # the whole solve pipeline)
        parent, l_indptr, l_indices = symbolic.chol_symbolic_csr(a)

    # Row-wise L pattern → CSC (column-wise) with diagonal first per column.
    l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
    l_cols = l_indices
    order = np.lexsort((l_rows, l_cols))  # by (col, row); row≥col ⇒ diag first
    csc_rows, csc_cols = l_rows[order], l_cols[order]
    nnz_l = csc_rows.shape[0]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr[1:], csc_cols, 1)
    col_ptr = np.cumsum(col_ptr)

    # Vectorised position lookup: CSC entries sorted by (col, row) means
    # key = col·n + row is ascending, so searchsorted resolves any (row, col)
    # to its position in the value array.
    csc_keys = csc_cols * n + csc_rows

    # A (lower incl. diagonal) scatter positions.
    keep = indices <= rows
    a_rows, a_cols = rows[keep], indices[keep]
    a_vals_idx = np.nonzero(keep)[0]
    # a_cols may be int32 from CSR storage: widen BEFORE the multiply
    # (int32*n overflows at n > 65535 under NumPy-2 promotion).
    a_src_pos = np.searchsorted(
        csc_keys, a_cols.astype(np.int64) * n + a_rows)

    # Fan-in levels over the etree.
    level = np.zeros(n, dtype=np.int64)
    for j in range(n):  # children precede parents (j < parent[j])
        p = parent[j]
        if p != -1:
            level[p] = max(level[p], level[j] + 1)
    nlev = int(level.max()) + 1 if n else 1

    # Update triples — native runtime: per level, (dst, src_a, src_b)
    # positions into L's value array (L[i,j] -= L[i,k]·L[j,k]); incomplete
    # patterns drop out-of-pattern destinations inside the generator.
    dst, ua, ub, lvl_of, counts, starts = symbolic.chol_update_triples(
        col_ptr, csc_rows, level, nlev
    )
    max_upd = max(int(counts.max()) if counts.size else 0, 1)
    scratch = nnz_l  # one scratch slot past the end of L's value array
    upd_dst = np.full((nlev, max_upd), scratch, dtype=np.int32)
    upd_a = np.full((nlev, max_upd), scratch, dtype=np.int32)
    upd_b = np.full((nlev, max_upd), scratch, dtype=np.int32)
    if dst.size:
        pos_in_level = np.arange(dst.shape[0]) - starts[lvl_of]
        upd_dst[lvl_of, pos_in_level] = dst
        upd_a[lvl_of, pos_in_level] = ua
        upd_b[lvl_of, pos_in_level] = ub

    # Column finalisation tables.
    cols_of_level = [np.nonzero(level == lv)[0] for lv in range(nlev)]
    max_cols = max(len(c) for c in cols_of_level)
    col_len = np.diff(col_ptr)
    max_len = int(col_len.max()) if n else 1
    col_pos = np.full((nlev, max_cols, max_len), scratch, dtype=np.int32)
    for lv, cols_ in enumerate(cols_of_level):
        for c, j in enumerate(cols_):
            lo, hi = int(col_ptr[j]), int(col_ptr[j + 1])
            col_pos[lv, c, : hi - lo] = np.arange(lo, hi, dtype=np.int32)

    sched = CholeskySchedule(
        a_src_pos=jnp.asarray(a_src_pos.astype(np.int32)),
        a_vals_idx=jnp.asarray(a_vals_idx.astype(np.int32)),
        upd_dst=jnp.asarray(upd_dst),
        upd_a=jnp.asarray(upd_a),
        upd_b=jnp.asarray(upd_b),
        col_pos=jnp.asarray(col_pos),
        nnz_l=nnz_l,
        n=n,
    )
    object.__setattr__(sched, "l_col_ptr", col_ptr)
    object.__setattr__(sched, "l_row_idx", csc_rows)
    return sched


@jax.jit
def factorize(sched: CholeskySchedule, a_values: jax.Array) -> jax.Array:
    """Numeric phase: returns L's CSC value array (length ``nnz_l``)."""
    # Value array with one trailing scratch slot absorbing padded updates.
    lvals = jnp.zeros(sched.nnz_l + 1, dtype=jnp.float32)
    lvals = lvals.at[sched.a_src_pos].add(
        a_values[sched.a_vals_idx].astype(jnp.float32)
    )
    nlev = sched.upd_dst.shape[0]

    def level_step(lv, lvals):
        # Apply every update targeting this level's columns.
        delta = lvals[sched.upd_a[lv]] * lvals[sched.upd_b[lv]]
        lvals = lvals.at[sched.upd_dst[lv]].add(-delta)
        lvals = lvals.at[-1].set(0.0)
        # Finalise this level's columns: sqrt diagonal, scale below-diagonal.
        pos = sched.col_pos[lv]                    # (C, Lmax)
        colv = lvals[pos]                          # (C, Lmax)
        diag = jnp.sqrt(colv[:, 0])
        inv = jnp.where(diag > 0, 1.0 / jnp.maximum(diag, 1e-30), 0.0)
        new = jnp.concatenate(
            [diag[:, None], colv[:, 1:] * inv[:, None]], axis=1
        )
        lvals = lvals.at[pos].set(new)
        return lvals.at[-1].set(0.0)

    lvals = jax.lax.fori_loop(0, nlev, level_step, lvals)
    return lvals[:-1]


def csc_to_csr_l(sched: CholeskySchedule, lvals: np.ndarray) -> CSR:
    """Assemble the factor as a row-major CSR (host)."""
    n = sched.n
    cols = np.repeat(np.arange(n), np.diff(sched.l_col_ptr))
    return CSR.from_coo_arrays((n, n), sched.l_row_idx, cols,
                               np.asarray(lvals), sum_duplicates=False,
                               drop_zeros=False)


def cholesky_sparse(a: CSR) -> CSR:
    """End-to-end sparse Cholesky: symbolic + numeric + assembly."""
    sched = analyze(a)
    lvals = jax.device_get(factorize(sched, a.values))
    return csc_to_csr_l(sched, lvals)
