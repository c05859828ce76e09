"""Matrix generators for the PDE problems the solvers are sized against."""

from __future__ import annotations

import numpy as np

from .csr import CSR


def laplacian_3d(k: int, diag: float = 6.0) -> CSR:
    """k×k×k 7-point stencil (Dirichlet boundary), n = k³, SPD. Its
    bandwidth ~k² exceeds the banded tier, so the direct-solve ladder lands
    on the supernodal factorization."""
    n = k ** 3
    ii, jj, ll = np.meshgrid(np.arange(k), np.arange(k), np.arange(k),
                             indexing="ij")
    rid = ((ii * k + jj) * k + ll).ravel()
    rows, cols, vals = [rid], [rid], [np.full(n, diag, np.float32)]
    for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1)):
        i2, j2, l2 = ii + d[0], jj + d[1], ll + d[2]
        ok = ((0 <= i2) & (i2 < k) & (0 <= j2) & (j2 < k)
              & (0 <= l2) & (l2 < k)).ravel()
        rows.append(rid[ok])
        cols.append(((i2 * k + j2) * k + l2).ravel()[ok])
        vals.append(np.full(int(ok.sum()), -1.0, np.float32))
    return CSR.from_coo_arrays((n, n), np.concatenate(rows),
                               np.concatenate(cols), np.concatenate(vals))
