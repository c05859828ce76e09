"""Host-side COO staging builder.

Reference counterpart: ``COO<T>`` + ``COOEntry`` (``/root/reference/src/
sparse.rs:7-66``): random-order bounds-checked inserts, then sort + replay
into CSR. Here the builder accumulates triplets in growable numpy buffers and
converts with one vectorised lexsort (no per-element replay loop).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from ..utils.errors import OutOfBounds, check
from ..utils.shapes import DimLike, MatDim
from .csr import CSR

EntryLike = Tuple[int, int, Union[int, float]]


class COO:
    """Append-only triplet buffer convertible to :class:`CSR`."""

    def __init__(self, dims: DimLike, capacity: int = 0, dtype=None):
        # reference COO::with_capacity (sparse.rs:41-43)
        self.dims = MatDim.of(dims)
        cap = max(int(capacity), 4)
        self._rows = np.empty(cap, dtype=np.int64)
        self._cols = np.empty(cap, dtype=np.int64)
        self._vals = np.empty(cap, dtype=dtype if dtype is not None else object)
        self._dtype = dtype
        self._n = 0

    @classmethod
    def with_capacity(cls, dims: DimLike, capacity: int = 0,
                      dtype=None) -> "COO":
        """Constructor alias matching the reference ``COO::with_capacity``
        (sparse.rs:41-43)."""
        return cls(dims, capacity, dtype)

    def __len__(self) -> int:
        return self._n

    def _grow(self) -> None:
        cap = max(4, 2 * self._rows.shape[0])
        for name in ("_rows", "_cols", "_vals"):
            buf = getattr(self, name)
            new = np.empty(cap, dtype=buf.dtype)
            new[: self._n] = buf[: self._n]
            setattr(self, name, new)

    def insert(self, entry: EntryLike) -> None:
        """Bounds-checked append — reference ``COO::insert``
        (sparse.rs:45-52) raising :class:`OutOfBounds` like its
        ``MatErr::OutOfBounds`` return."""
        row, col, value = entry
        check(
            0 <= row < self.dims.rows and 0 <= col < self.dims.cols,
            OutOfBounds,
            f"entry ({row},{col}) outside {self.dims}",
        )
        if self._n == self._rows.shape[0]:
            self._grow()
        self._rows[self._n] = row
        self._cols[self._n] = col
        self._vals[self._n] = value
        self._n += 1

    def insert_many(self, rows, cols, vals) -> None:
        """Vectorised bulk append (no reference counterpart; the fast path
        for bench-scale construction)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        if rows.size:
            check(
                bool((rows >= 0).all() and (rows < self.dims.rows).all()),
                OutOfBounds, "row index out of bounds",
            )
            check(
                bool((cols >= 0).all() and (cols < self.dims.cols).all()),
                OutOfBounds, "col index out of bounds",
            )
        need = self._n + rows.size
        while self._rows.shape[0] < need:
            self._grow()
        sl = slice(self._n, need)
        self._rows[sl], self._cols[sl], self._vals[sl] = rows, cols, vals
        self._n = need

    def to_csr(self, *, sum_duplicates: bool = True,
               drop_zeros: bool = True) -> CSR:
        """Sort + merge + convert — reference ``From<COO> for Csr``
        (sparse.rs:56-66). The reference replays through ``insert`` which
        keeps duplicates as separate entries; we default to summing them
        (scipy semantics) — pass ``sum_duplicates=False`` for raw replay."""
        vals = self._vals[: self._n]
        if self._dtype is None and vals.dtype == object:
            vals = np.asarray(vals.tolist())
        return CSR.from_coo_arrays(
            self.dims,
            self._rows[: self._n],
            self._cols[: self._n],
            vals,
            sum_duplicates=sum_duplicates,
            drop_zeros=drop_zeros,
        )
