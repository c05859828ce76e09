"""Distributed-layer tests on the simulated 8-device CPU mesh
(SURVEY.md §4: multi-device paths must be testable without the devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.parallel.cg import cg_solve_sharded
from basic_sparse_matrix_tpu.parallel.mesh import make_mesh, row_mesh
from basic_sparse_matrix_tpu.parallel.sharded import (
    shard_csr,
    put_sharded,
    unshard_rows,
)
from basic_sparse_matrix_tpu.parallel.spmm import (
    spmm_allgather,
    spmm_ring,
    spmm_sharded,
    spmv_sharded,
)


def _random_csr(rng, rows, cols, density=0.1):
    d = (rng.random((rows, cols)) < density) * rng.standard_normal(
        (rows, cols)
    )
    return CSR.from_dense(d.astype(np.float32)), d.astype(np.float32)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return row_mesh(8)


def test_shard_roundtrip(mesh8):
    rng = np.random.default_rng(0)
    a, d = _random_csr(rng, 100, 64)  # 100 rows: uneven split, forces padding
    sa = put_sharded(shard_csr(a, 8), mesh8)
    assert sa.padded_rows >= 100
    # each shard's local CSR must reproduce its row block
    indptr = np.asarray(sa.indptr)
    indices = np.asarray(sa.indices)
    values = np.asarray(sa.values)
    for s in range(8):
        local = CSR(
            indptr=jnp.asarray(indptr[s]),
            indices=jnp.asarray(indices[s]),
            values=jnp.asarray(values[s]),
            rows=sa.rows_per_shard,
            cols=64,
        )
        block = np.zeros((sa.rows_per_shard, 64), dtype=np.float32)
        r0 = s * sa.rows_per_shard
        r1 = min(r0 + sa.rows_per_shard, 100)
        if r0 < 100:
            block[: r1 - r0] = d[r0:r1]
        assert np.allclose(np.asarray(local.todense()), block)


def test_spmv_sharded(mesh8):
    rng = np.random.default_rng(1)
    a, d = _random_csr(rng, 96, 50)
    x = rng.standard_normal(50).astype(np.float32)
    sa = put_sharded(shard_csr(a, 8), mesh8)
    y = spmv_sharded(sa, jnp.asarray(x), mesh8)
    assert np.allclose(
        np.asarray(unshard_rows(y, 96)), d @ x, rtol=1e-4, atol=1e-4
    )


def test_spmm_sharded(mesh8):
    rng = np.random.default_rng(2)
    a, d = _random_csr(rng, 64, 40)
    b = rng.standard_normal((40, 7)).astype(np.float32)
    sa = put_sharded(shard_csr(a, 8), mesh8)
    y = spmm_sharded(sa, jnp.asarray(b), mesh8)
    assert np.allclose(
        np.asarray(unshard_rows(y, 64)), d @ b, rtol=1e-4, atol=1e-4
    )


def test_spmm_allgather(mesh8):
    rng = np.random.default_rng(3)
    a, d = _random_csr(rng, 64, 100)  # K=100 pads to 104
    b = rng.standard_normal((100, 5)).astype(np.float32)
    sa = put_sharded(shard_csr(a, 8), mesh8)
    y = spmm_allgather(sa, jnp.asarray(b), mesh8)
    assert np.allclose(
        np.asarray(unshard_rows(y, 64)), d @ b, rtol=1e-4, atol=1e-4
    )


def test_spmm_ring(mesh8):
    rng = np.random.default_rng(4)
    a, d = _random_csr(rng, 72, 90)
    b = rng.standard_normal((90, 6)).astype(np.float32)
    sa = put_sharded(shard_csr(a, 8), mesh8)
    y = spmm_ring(sa, jnp.asarray(b), mesh8)
    assert np.allclose(
        np.asarray(unshard_rows(y, 72)), d @ b, rtol=1e-4, atol=1e-4
    )


def test_cg_solve_sharded(mesh8):
    rng = np.random.default_rng(5)
    n = 64
    m = rng.standard_normal((n, n)).astype(np.float32)
    spd = m @ m.T + n * np.eye(n, dtype=np.float32)
    a = CSR.from_dense(spd)
    b = rng.standard_normal(n).astype(np.float32)
    sa = put_sharded(shard_csr(a, 8), mesh8)
    x = cg_solve_sharded(sa, jnp.asarray(b), mesh8, iters=200)
    x = np.asarray(x)[:n]
    assert np.allclose(spd @ x, b, rtol=1e-2, atol=1e-2)


def test_mesh_2d():
    mesh = make_mesh((4, 2))
    assert mesh.axis_names == ("rows", "cols")
    assert mesh.devices.shape == (4, 2)


def test_spmm_sharded_ell(mesh8):
    from basic_sparse_matrix_tpu.ops.ell import csr_to_ell
    from basic_sparse_matrix_tpu.parallel.spmm import spmm_sharded_ell

    rng = np.random.default_rng(9)
    d = ((rng.random((100, 64)) < 0.1)
         * rng.standard_normal((100, 64))).astype(np.float32)
    ell = csr_to_ell(CSR.from_dense(d))
    b = rng.standard_normal((64, 5)).astype(np.float32)
    y = np.asarray(spmm_sharded_ell(ell, jnp.asarray(b), mesh8))[:100]
    assert np.allclose(y, d @ b, rtol=1e-4, atol=1e-4)
