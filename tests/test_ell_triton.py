"""The Pallas-Triton ELL kernel: interpret-mode equality with the XLA path
at unaligned shapes, the dispatch rule, and (on a GPU) the compiled kernel
at a real width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.ops.ell import (
    ELL,
    csr_to_ell,
    spmm_ell,
    spmm_ell_xla,
    use_triton_kernel,
)
from basic_sparse_matrix_tpu.ops.ell_triton import spmm_ell_triton


def _ell(rows, k, density, seed):
    rng = np.random.default_rng(seed)
    d = ((rng.random((rows, k)) < density)
         * rng.standard_normal((rows, k))).astype(np.float32)
    return csr_to_ell(CSR.from_dense(d)), d


@pytest.mark.parametrize("rows,k,n,density,block_rows,block_cols", [
    (100, 70, 5, 0.1, 16, 64),       # rows and RHS both unaligned
    (64, 64, 128, 0.2, 16, 64),      # aligned
    (37, 200, 130, 0.05, 32, 128),   # one column past a tile
    (257, 40, 16, 0.3, 64, 16),      # rectangular, narrow RHS
])
def test_interpret_matches_xla(rows, k, n, density, block_rows, block_cols):
    ell, d = _ell(rows, k, density, rows + n)
    b = np.random.default_rng(n).standard_normal((k, n)).astype(np.float32)
    got = np.asarray(spmm_ell_triton(ell, jnp.asarray(b),
                                     block_rows=block_rows,
                                     block_cols=block_cols, interpret=True))
    ref = np.asarray(spmm_ell_xla(ell, jnp.asarray(b)))
    assert got.shape == (rows, n)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, d @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width,n_rhs,dtype,backend,want", [
    (32, 512, jnp.float32, "gpu", True),
    (32, 128, jnp.float32, "gpu", True),
    (32, 127, jnp.float32, "gpu", False),     # narrower than one tile
    (65, 512, jnp.float32, "gpu", False),     # too wide to unroll
    (32, 512, jnp.bfloat16, "gpu", False),
    (32, 512, jnp.float32, "cpu", False),
])
def test_dispatch_rule(width, n_rhs, dtype, backend, want):
    assert use_triton_kernel(width, n_rhs, dtype, backend) is want


def test_cpu_dispatch_is_xla():
    ell, d = _ell(50, 50, 0.1, 0)
    b = np.ones((50, 128), np.float32)
    np.testing.assert_allclose(np.asarray(spmm_ell(ell, jnp.asarray(b))),
                               d @ b, rtol=1e-5, atol=1e-5)


def test_kernel_under_shard_map(monkeypatch):
    """The GPU path of the row-sharded ELL SpMM (the kernel inside
    shard_map), run with the kernel interpreted on 4 CPU devices."""
    import functools

    from basic_sparse_matrix_tpu.ops import ell as E
    from basic_sparse_matrix_tpu.ops import ell_triton as T
    from basic_sparse_matrix_tpu.parallel.mesh import row_mesh
    from basic_sparse_matrix_tpu.parallel.spmm import (
        shard_ell,
        spmm_sharded_ell,
    )

    calls = []
    kernel = functools.partial(T.spmm_ell_triton, block_rows=16,
                               block_cols=16, interpret=True)
    monkeypatch.setattr(E, "use_triton_kernel", lambda *a: True)
    monkeypatch.setattr(T, "spmm_ell_triton",
                        lambda *a: calls.append(1) or kernel(*a))
    a = CSR.from_dense(np.asarray(_ell(101, 101, 0.05, 3)[1]))
    d = np.asarray(a.todense())
    b = np.random.default_rng(4).standard_normal((101, 24)).astype(
        np.float32)
    mesh = row_mesh(4)
    y = spmm_sharded_ell(shard_ell(a, mesh), jnp.asarray(b), mesh)
    assert calls and len(y.sharding.device_set) == 4
    np.testing.assert_allclose(np.asarray(y)[:101], d @ b, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_at_real_width():
    rows, per_row, n_rhs = 100_000, 32, 512
    kc, kv, kb = jax.random.split(jax.random.key(0), 3)
    ell = ELL(cols=jax.random.randint(kc, (rows, per_row), 0, rows,
                                      jnp.int32),
              vals=jax.random.normal(kv, (rows, per_row), jnp.float32),
              n_cols=rows)
    b = jax.random.normal(kb, (rows, n_rhs), jnp.float32)
    got = spmm_ell(ell, b)
    ref = spmm_ell_xla(ell, b)
    err = float(jnp.abs(got - ref).max() / jnp.abs(ref).max())
    assert err <= 1e-6
