"""Distributed correctness past toy size.

The r1-r4 mesh tests ran at n <= 64 — no multi-level elimination
structure, no ragged shard boundaries, one block per device. These drive
the distributed direct and iterative pipelines on 3D nested-dissection
problems at n = 2197 / 9261 with 8-way row sharding that does NOT divide n
(2197 = 8*274 + 5, 9261 = 8*1157 + 5).

Scale notes (measured on the 2-core CI host): the chunked distributed
supernodal numeric compiles ~1-2 s per schedule group on CPU, so the
factorization target is k=13 (27 groups); the iterative/triangular paths
compile a single program each and run at k=21. The full k=21 chunked
factorization was verified out-of-suite (rel resid 5.8e-7, 101 s wall on
the CPU).
"""

import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.ops.reorder import (
    nd_permutation,
    permute_symmetric,
)
from basic_sparse_matrix_tpu.parallel.mesh import row_mesh


@pytest.fixture(scope="module")
def mesh8():
    return row_mesh(8)


def _lap3d(k, diag=6.05):
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    rows, cols = [], []
    for ax in range(3):
        sa = [slice(None)] * 3
        sb = [slice(None)] * 3
        sa[ax] = slice(0, k - 1)
        sb[ax] = slice(1, k)
        a_ = idx[tuple(sa)].ravel()
        b_ = idx[tuple(sb)].ravel()
        rows += [a_, b_]
        cols += [b_, a_]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = -np.ones(rows.shape[0], dtype=np.float32)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, diag * np.ones(n, dtype=np.float32)])
    return CSR.from_coo_arrays((n, n), rows, cols, vals)


def _spmv_host(a: CSR, x: np.ndarray) -> np.ndarray:
    indptr, indices, vals = a.numpy()
    out = np.zeros(a.rows, dtype=np.float64)
    np.add.at(out, np.repeat(np.arange(a.rows), np.diff(indptr)),
              vals.astype(np.float64)[np.arange(len(indices))]
              * x[indices])
    return out


def test_distributed_supernodal_triangular_scale(mesh8):
    """k=13 (n=2197, ragged 8-way): chunked distributed supernodal
    factorization under ND, then distributed fwd/bwd triangular solves,
    verified by the residual of the assembled solve."""
    import jax
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.models.supernodal import (
        analyze_supernodal,
        assemble_factor,
    )
    from basic_sparse_matrix_tpu.parallel.supernodal import (
        factorize_supernodal_sharded,
    )
    from basic_sparse_matrix_tpu.parallel.triangular import (
        solve_sparse_distributed,
    )

    a = _lap3d(13)
    n = a.rows
    assert n % 8 != 0  # ragged shard boundaries are the point
    ap = permute_symmetric(a, nd_permutation(a))
    sched = analyze_supernodal(ap, relax=64)
    assert sched.n_groups > 20  # multi-level elimination structure
    lv = np.asarray(jax.device_get(factorize_supernodal_sharded(
        sched, ap.values, mesh8, chunk_groups=16)))
    l = assemble_factor(ap, lv, sched)

    # L L^T == Ap (sparse residual — no dense n^2 materialisation)
    ip, ix, vv = l.numpy()
    L = sp.csr_matrix((vv, ix, ip), shape=(n, n))
    ipa, ixa, vva = ap.numpy()
    A = sp.csr_matrix((vva, ixa, ipa), shape=(n, n))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    rel = (np.abs(L @ (L.T @ x) - A @ x).max()
           / np.abs(A @ x).max())
    assert rel < 1e-5

    # distributed fwd/bwd solve on the factor
    b = rng.standard_normal((n, 1)).astype(np.float32)
    y = solve_sparse_distributed(l, b, mesh8, lower=True)
    xx = np.asarray(
        solve_sparse_distributed(l.transpose(), y, mesh8, lower=False))
    resid = np.abs(A @ xx.ravel() - b.ravel()).max()
    assert resid < 1e-3 * np.abs(b).max()


def test_distributed_pcg_scale_to_tolerance(mesh8):
    """k=21 (n=9261, ragged 8-way, >1157 rows per device): block-Jacobi
    PCG driven to tolerance on the ND-permuted operator."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.parallel.pcg import (
        build_block_jacobi,
        pcg_solve_sharded,
    )
    from basic_sparse_matrix_tpu.parallel.sharded import (
        put_sharded,
        shard_csr,
        unshard_rows,
    )

    a = _lap3d(21)
    n = a.rows
    assert n % 8 != 0
    ap = permute_symmetric(a, nd_permutation(a))
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n).astype(np.float32)
    sa = put_sharded(shard_csr(ap, 8), mesh8)
    lfac = build_block_jacobi(sa, mesh8)
    x = pcg_solve_sharded(sa, jnp.asarray(b), mesh8, iters=60, lfac=lfac)
    xr = np.asarray(unshard_rows(x, n))
    ipa, ixa, vva = ap.numpy()
    A = sp.csr_matrix((vva, ixa, ipa), shape=(n, n))
    rel = np.linalg.norm(A @ xr - b) / np.linalg.norm(b)
    assert rel < 1e-4


def test_distributed_spmm_scale_ragged(mesh8):
    """Ring SpMM at n=9261 with ragged shards matches the host product."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.parallel.sharded import (
        put_sharded,
        shard_csr,
        unshard_rows,
    )
    from basic_sparse_matrix_tpu.parallel.spmm import spmm_ring

    a = _lap3d(21)
    n = a.rows
    rng = np.random.default_rng(2)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    sa = put_sharded(shard_csr(a, 8), mesh8)
    y = np.asarray(unshard_rows(spmm_ring(sa, jnp.asarray(b), mesh8), n))
    ipa, ixa, vva = a.numpy()
    A = sp.csr_matrix((vva, ixa, ipa), shape=(n, n))
    assert np.abs(y - A @ b).max() < 1e-3
