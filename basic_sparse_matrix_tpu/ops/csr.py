"""Immutable device-resident CSR matrix — the core storage type.

Reference counterpart: ``Csr<T>`` (``/root/reference/src/sparse.rs:68-423``).
The reference builds CSR *mutably* (monotone ``insert`` + ``finalise``,
sparse.rs:222-250) because incremental Rust favours it. That design is wrong
for XLA: here a :class:`CSR` is an **immutable pytree** of three device arrays
(``indptr``/``indices``/``values``) with static shape metadata, constructed in
one shot on the host (numpy) and consumed by jit-compiled ops. "finalise"
(sparse.rs:206-219) becomes a constructor invariant: every CSR is always
finalised; ``indptr`` always has ``rows+1`` entries ending in the storage size.

Storage semantics
-----------------
* Entries are sorted row-major (row, then col) — the invariant the reference
  establishes via monotone insert.
* Explicit zeros are dropped by *host* constructors (matching reference
  ``insert``'s "silently ignore default values", sparse.rs:229).
* Jit-traced ops that cannot know output nnz statically (add/sub) return a CSR
  at full static capacity where cancelled/merged slots hold explicit zero
  values; ``compacted()`` (host-side) drops them. Value-level semantics are
  unaffected — every op here tolerates explicit zeros and duplicate
  coordinates (duplicates sum).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.errors import (
    IncorrectDimensions,
    NonSquareMatrix,
    OutOfBounds,
    PaddingSizeSmallerThanOriginal,
    check,
)
from ..utils.shapes import DimLike, MatDim


class CsrEntry(NamedTuple):
    """One stored entry, as yielded by iteration (reference ``CsrEntry``,
    sparse.rs:80-91)."""

    v: object
    row_index: int
    col_index: int


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """CSR sparse matrix: ``indptr`` (rows+1, int32), ``indices`` (nnz, int32),
    ``values`` (nnz, dtype). ``rows``/``cols`` are static pytree metadata so
    the type traces cleanly through ``jax.jit`` / ``shard_map``."""

    indptr: jax.Array
    indices: jax.Array
    values: jax.Array
    rows: int = dataclasses.field(metadata=dict(static=True))
    cols: int = dataclasses.field(metadata=dict(static=True))

    # ------------------------------------------------------------------ #
    # Static metadata
    # ------------------------------------------------------------------ #
    @property
    def dims(self) -> MatDim:
        """Reference ``GetDims::get_dims`` (sparse.rs:418-422)."""
        return MatDim(self.rows, self.cols)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def stored(self) -> int:
        """Static storage size (number of stored entries, incl. any explicit
        zeros introduced by capacity-padded traced ops)."""
        return int(self.values.shape[0])

    def get_nnz(self) -> int:
        """Number of stored entries — reference ``get_nnz`` reads the last
        ``row_index`` entry (sparse.rs:162-164), which equals the stored count
        because host constructors drop explicit zeros."""
        return self.stored

    def count_nonzero(self) -> int:
        """Actual nonzero count (host-side; differs from :meth:`get_nnz` only
        after capacity-padded traced ops)."""
        return int(np.count_nonzero(np.asarray(self.values)))

    def get_density(self) -> float:
        """Reference ``get_density`` (sparse.rs:166-168)."""
        return self.stored / float(self.rows * self.cols)

    # ------------------------------------------------------------------ #
    # Host constructors (numpy; exact nnz, zeros dropped, sorted row-major)
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_coo_arrays(
        dims: DimLike,
        row_ids: np.ndarray,
        col_ids: np.ndarray,
        vals: np.ndarray,
        *,
        sum_duplicates: bool = True,
        drop_zeros: bool = True,
        dtype=None,
    ) -> "CSR":
        """Vectorised COO → CSR: lexsort by (row, col), optionally merge
        duplicates and drop zeros. Replaces the reference's sort-then-replay
        loop (``From<COO> for Csr``, sparse.rs:56-66) with O(nnz log nnz)
        numpy — no per-element insert."""
        d = MatDim.of(dims)
        row_ids = np.asarray(row_ids, dtype=np.int64)
        col_ids = np.asarray(col_ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=dtype)
        if row_ids.size:
            check(
                bool((row_ids >= 0).all() and (row_ids < d.rows).all()),
                OutOfBounds,
                "row index out of bounds",
            )
            check(
                bool((col_ids >= 0).all() and (col_ids < d.cols).all()),
                OutOfBounds,
                "col index out of bounds",
            )
        order = np.lexsort((col_ids, row_ids))
        row_ids, col_ids, vals = row_ids[order], col_ids[order], vals[order]
        if sum_duplicates and row_ids.size:
            keys = row_ids * d.cols + col_ids
            uniq, inv = np.unique(keys, return_inverse=True)
            merged = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(merged, inv, vals)
            row_ids, col_ids, vals = uniq // d.cols, uniq % d.cols, merged
        if drop_zeros and row_ids.size:
            keep = vals != 0
            row_ids, col_ids, vals = row_ids[keep], col_ids[keep], vals[keep]
        indptr = np.zeros(d.rows + 1, dtype=np.int32)
        np.add.at(indptr[1:], row_ids, 1)
        indptr = np.cumsum(indptr, dtype=np.int32)
        indices_np = col_ids.astype(np.int32)
        out = CSR(
            indptr=jnp.asarray(indptr),
            indices=jnp.asarray(indices_np),
            values=jnp.asarray(vals),
            rows=d.rows,
            cols=d.cols,
        )
        # Host-side mirror: host-constructed CSRs keep their numpy triple so
        # host plans, accessors and format conversions never read back.
        object.__setattr__(out, "_host", (indptr, indices_np, vals))
        return out

    @staticmethod
    def from_dense(arr, *, drop_zeros: bool = True) -> "CSR":
        """Build from a dense array, dropping explicit zeros — value-level
        equivalent of reference ``from_data`` (sparse.rs:193-203)."""
        a = np.asarray(arr)
        check(a.ndim == 2, IncorrectDimensions, "from_dense requires 2D data")
        rows, cols = np.nonzero(a) if drop_zeros else np.unravel_index(
            np.arange(a.size), a.shape
        )
        return CSR.from_coo_arrays(
            a.shape, rows, cols, a[rows, cols], sum_duplicates=False,
            drop_zeros=False, dtype=a.dtype,
        )

    # Parity alias matching the reference constructor name.
    from_data = from_dense

    @staticmethod
    def eye(dims: DimLike, value=1.0, dtype=None) -> "CSR":
        """Identity scaled by ``value`` — reference ``eye`` (sparse.rs:134-152)
        including its non-square error."""
        d = MatDim.of(dims)
        check(d.rows == d.cols, IncorrectDimensions, "eye requires square dims")
        n = d.rows
        vals = np.full(n, value, dtype=dtype)
        return CSR.from_coo_arrays(d, np.arange(n), np.arange(n), vals,
                                   sum_duplicates=False)

    @staticmethod
    def create_diagonal(contents: Sequence) -> "CSR":
        """Diagonal matrix; zero entries dropped — reference
        ``create_diagonal`` (sparse.rs:154-160) whose ``insert`` drops zeros
        (verified by its test, sparse.rs:1486-1498)."""
        v = np.asarray(contents)
        n = v.shape[0]
        return CSR.from_coo_arrays((n, n), np.arange(n), np.arange(n), v)

    @staticmethod
    def empty(dims: DimLike, dtype=jnp.float32) -> "CSR":
        d = MatDim.of(dims)
        return CSR(
            indptr=jnp.zeros(d.rows + 1, dtype=jnp.int32),
            indices=jnp.zeros((0,), dtype=jnp.int32),
            values=jnp.zeros((0,), dtype=dtype),
            rows=d.rows,
            cols=d.cols,
        )

    # ------------------------------------------------------------------ #
    # Densify / host views
    # ------------------------------------------------------------------ #
    def todense(self) -> jax.Array:
        """Scatter stored entries into a dense array (duplicates sum).
        Jit-compatible. Guarded against shapes whose flat index would
        overflow int32 (x64 is off by default) — such arrays would not fit
        memory anyway."""
        check(self.rows * self.cols < 2**31, IncorrectDimensions,
              f"todense of {self.dims} would overflow int32 flat indexing")
        flat = jnp.zeros(self.rows * self.cols, dtype=self.dtype)
        pos = self.row_ids() * self.cols + self.indices
        flat = flat.at[pos].add(self.values)
        return flat.reshape(self.rows, self.cols)

    def row_ids(self) -> jax.Array:
        """Expand ``indptr`` into a per-entry row id vector (nnz,). The static
        ``total_repeat_length`` keeps this jit-compatible."""
        return jnp.repeat(
            jnp.arange(self.rows, dtype=jnp.int32),
            jnp.diff(self.indptr),
            total_repeat_length=self.stored,
        )

    def numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        host = getattr(self, "_host", None)
        if host is not None:
            return host
        host = (
            np.asarray(self.indptr),
            np.asarray(self.indices),
            np.asarray(self.values),
        )
        object.__setattr__(self, "_host", host)
        return host

    def compacted(self) -> "CSR":
        """Host-side re-normalisation: merge duplicate coordinates and drop
        explicit zeros. Restores reference storage semantics after
        capacity-padded traced ops."""
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        return CSR.from_coo_arrays(self.dims, rows, indices, values)

    # ------------------------------------------------------------------ #
    # Accessors (host-side; reference sparse.rs:170-411)
    # ------------------------------------------------------------------ #
    def get_val_at(self, at: DimLike):
        """Value at (row, col) or ``None`` — reference ``get_val_at``
        (sparse.rs:170-180)."""
        d = MatDim.of(at)
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[d.rows]), int(indptr[d.rows + 1])
        hit = np.nonzero(indices[lo:hi] == d.cols)[0]
        if hit.size == 0:
            return None
        return values[lo:hi][hit].sum() if hit.size > 1 else values[lo + hit[0]]

    def with_val_at(self, at: DimLike, value) -> "CSR":
        """Functional update of one coordinate — the immutable counterpart
        of reference ``get_mut_val_at`` (sparse.rs:182-191, which has a
        row/col comparison bug; this sets the entry the caller named).
        Existing entries are updated in place; a new coordinate is inserted
        (host-side rebuild)."""
        d = MatDim.of(at)
        check(0 <= d.rows < self.rows and 0 <= d.cols < self.cols,
              OutOfBounds, f"({d.rows},{d.cols}) outside {self.dims}")
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[d.rows]), int(indptr[d.rows + 1])
        hit = np.nonzero(indices[lo:hi] == d.cols)[0]
        if hit.size:
            new_vals = values.copy()
            new_vals[lo + hit[0]] = value
            return CSR.from_coo_arrays(
                self.dims,
                np.repeat(np.arange(self.rows), np.diff(indptr)),
                indices, new_vals, sum_duplicates=False, drop_zeros=False,
            )
        rows_ids = np.repeat(np.arange(self.rows), np.diff(indptr))
        return CSR.from_coo_arrays(
            self.dims,
            np.concatenate([rows_ids, [d.rows]]),
            np.concatenate([indices, [d.cols]]),
            np.concatenate([values, [value]]),
            sum_duplicates=False, drop_zeros=False,
        )

    def get_row_compact(self, index: int) -> List[CsrEntry]:
        """Stored entries of one row — reference ``get_row_compact``
        (sparse.rs:252-265)."""
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[index]), int(indptr[index + 1])
        return [
            CsrEntry(values[k], index, int(indices[k])) for k in range(lo, hi)
        ]

    def get_row_complete(self, index: int) -> np.ndarray:
        """Zero-filled full row — reference ``get_row_complete``
        (sparse.rs:267-294)."""
        indptr, indices, values = self.numpy()
        lo, hi = int(indptr[index]), int(indptr[index + 1])
        out = np.zeros(self.cols, dtype=values.dtype)
        np.add.at(out, indices[lo:hi], values[lo:hi])
        return out

    def get_col_compact(self, index: int) -> List[CsrEntry]:
        """Stored entries of one column — reference ``get_col_compact``
        (sparse.rs:326-342). O(nnz) scan there; vectorised mask here."""
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        hit = np.nonzero(indices == index)[0]
        return [CsrEntry(values[k], int(rows[k]), index) for k in hit]

    def get_col_complete(self, index: int) -> np.ndarray:
        """Zero-filled full column — reference ``get_col_complete``
        (sparse.rs:344-364)."""
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        out = np.zeros(self.rows, dtype=values.dtype)
        hit = indices == index
        np.add.at(out, rows[hit], values[hit])
        return out

    def get_col(self, index: int) -> "CSR":
        """One column as an (rows × 1) CSR — reference ``get_col``
        (sparse.rs:366-377)."""
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        hit = indices == index
        return CSR.from_coo_arrays(
            (self.rows, 1), rows[hit], np.zeros(int(hit.sum()), dtype=np.int64),
            values[hit], sum_duplicates=False, drop_zeros=False,
        )

    def take_submatrix(self, frm: DimLike, to: DimLike) -> "CSR":
        """Window ``[frm, to)`` — reference ``take_submatrix``
        (sparse.rs:379-411; its golden tests sparse.rs:1326-1367 pin plain
        half-open slicing, which is what we implement)."""
        f, t = MatDim.of(frm), MatDim.of(to)
        check(f.cols < t.cols and f.rows < t.rows, IncorrectDimensions,
              "empty submatrix window")
        check(t.rows <= self.rows and t.cols <= self.cols, OutOfBounds,
              "submatrix window exceeds matrix")
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        keep = (
            (rows >= f.rows) & (rows < t.rows)
            & (indices >= f.cols) & (indices < t.cols)
        )
        return CSR.from_coo_arrays(
            (t.rows - f.rows, t.cols - f.cols),
            rows[keep] - f.rows, indices[keep] - f.cols, values[keep],
            sum_duplicates=False, drop_zeros=False,
        )

    def add_padding(self, padded_size: DimLike, at: DimLike) -> "CSR":
        """Embed into a larger zero matrix at offset ``at`` — reference
        ``add_padding`` (sparse.rs:655-674). Pure index arithmetic instead of
        the reference's clone-and-iterate re-insert loop."""
        p, off = MatDim.of(padded_size), MatDim.of(at)
        check(self.rows <= p.rows and self.cols <= p.cols,
              PaddingSizeSmallerThanOriginal,
              "padded size smaller than matrix")
        check(
            p.rows >= self.rows + off.rows and p.cols >= self.cols + off.cols,
            IncorrectDimensions, "offset pushes matrix outside padded size",
        )
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        return CSR.from_coo_arrays(
            p, rows + off.rows, indices + off.cols, values,
            sum_duplicates=False, drop_zeros=False,
        )

    # ------------------------------------------------------------------ #
    # Iteration (reference Iterator impl, sparse.rs:93-114 — but stateless:
    # the reference stores the cursor in the matrix itself; we just yield)
    # ------------------------------------------------------------------ #
    def __iter__(self) -> Iterator[CsrEntry]:
        indptr, indices, values = self.numpy()
        rows = np.repeat(np.arange(self.rows), np.diff(indptr))
        for k in range(values.shape[0]):
            yield CsrEntry(values[k], int(rows[k]), int(indices[k]))

    # ------------------------------------------------------------------ #
    # Convenience operator sugar (delegates to ops modules; imported lazily
    # to avoid cycles)
    # ------------------------------------------------------------------ #
    def transpose(self) -> "CSR":
        from .transpose import transpose as _transpose

        return _transpose(self)

    @property
    def T(self) -> "CSR":
        return self.transpose()

    def pair_with_transpose(self) -> Tuple["CSR", "CSR"]:
        """Reference ``pair_with_tranpose`` [sic] (sparse.rs:320-323)."""
        return self, self.transpose()

    def __matmul__(self, other):
        if isinstance(other, CSR):
            from . import spgemm as _g

            return _g.spgemm(self, other)
        from . import spmm as _m

        arr = jnp.asarray(other)
        if arr.ndim == 1:
            return _m.spmv(self, arr)
        return _m.spmm(self, arr)

    def __add__(self, other: "CSR") -> "CSR":
        from . import elementwise as _e

        return _e.add(self, other)

    def __sub__(self, other: "CSR") -> "CSR":
        from . import elementwise as _e

        return _e.sub(self, other)

    def __mul__(self, scalar) -> "CSR":
        from . import elementwise as _e

        return _e.mul_scalar(self, scalar)

    __rmul__ = __mul__

    def sum_elements(self):
        from . import elementwise as _e

        return _e.sum_elements(self)

    def l2_norm(self):
        from . import elementwise as _e

        return _e.l2_norm(self)

    # ------------------------------------------------------------------ #
    # Display (reference Display/Debug impls, sparse.rs:777-805)
    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:
        return (
            f"CSR(dims: {self.dims}, stored: {self.stored}, "
            f"dtype: {self.dtype})"
        )

    def __str__(self) -> str:
        dense = np.asarray(self.todense())
        body = "\n".join(
            "|" + " ".join(f"{v:>5}" for v in row) + " |" for row in dense
        )
        return body

    def debug_str(self) -> str:
        """Raw-array dump mirroring the reference ``Debug`` impl
        (sparse.rs:797-805)."""
        indptr, indices, values = self.numpy()
        return (
            f"dims:      {self.dims}\n"
            f"v:         {values.tolist()}\n"
            f"col_index: {indices.tolist()}\n"
            f"row_index: {indptr.tolist()}\n"
        )

    def allclose(self, other: "CSR", rtol=1e-5, atol=1e-6) -> bool:
        """Value-level equality (densified comparison). The reference derives
        ``PartialEq`` over raw arrays; representation-level equality is not
        meaningful across frameworks, value-level is."""
        if self.shape != other.shape:
            return False
        return bool(
            np.allclose(
                np.asarray(self.todense()), np.asarray(other.todense()),
                rtol=rtol, atol=atol,
            )
        )
