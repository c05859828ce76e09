"""Integer-dtype algebra parity.

The reference is generic over T and its benches exercise ``Csr<u32>``
(``/root/reference/src/sparse.rs:425``, ``benches/sparse_dense_mul.rs:13-23``).
Storage here is dtype-generic jax arrays; these tests pin the integer
semantics exactly (array_equal, no float tolerance) for add/sub/spmm/
spgemm/reductions at the reference's u32 recipe plus signed i32.
"""

import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.ops import (
    add_sparse,
    mul_scalar,
    mul_sparse,
    mul_vector,
    spmm,
    sub_sparse,
    sum_elements,
)


def _coo(seed, n=60, nnz=300, dtype=np.uint32, lo=0, hi=255):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.integers(lo, hi, nnz).astype(dtype)
    return (n, rows, cols, vals)


def _dense_of(n, rows, cols, vals):
    d = np.zeros((n, n), dtype=vals.dtype)
    np.add.at(d, (rows, cols), vals)
    return d


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_add_integer_exact(dtype):
    n, ra, ca, va = _coo(1, dtype=dtype)
    _, rb, cb, vb = _coo(2, dtype=dtype)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    b = CSR.from_coo_arrays((n, n), rb, cb, vb)
    assert a.values.dtype == dtype
    out = add_sparse(a, b)
    assert out.values.dtype == dtype
    ref = _dense_of(n, ra, ca, va) + _dense_of(n, rb, cb, vb)
    assert np.array_equal(np.asarray(out.todense()), ref)


def test_sub_integer_exact_signed():
    # Signed subtraction (u32 sub would wrap — the reference's Sub<u32>
    # panics on underflow in debug; we pin the i32 semantics instead).
    n, ra, ca, va = _coo(3, dtype=np.int32, lo=-100, hi=100)
    _, rb, cb, vb = _coo(4, dtype=np.int32, lo=-100, hi=100)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    b = CSR.from_coo_arrays((n, n), rb, cb, vb)
    out = sub_sparse(a, b)
    assert out.values.dtype == np.int32
    ref = _dense_of(n, ra, ca, va) - _dense_of(n, rb, cb, vb)
    assert np.array_equal(np.asarray(out.todense()), ref)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_spmm_integer_exact(dtype):
    import jax.numpy as jnp

    n, ra, ca, va = _coo(5, n=40, nnz=200, dtype=dtype)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    rng = np.random.default_rng(6)
    bd = rng.integers(0, 16, (n, 8)).astype(dtype)
    out = spmm(a, jnp.asarray(bd))
    ref = _dense_of(n, ra, ca, va).astype(np.int64) @ bd.astype(np.int64)
    # Products stay well under 2^31, so the int32/uint32 result is exact.
    assert np.array_equal(np.asarray(out).astype(np.int64), ref)


def test_spmv_integer_exact():
    import jax.numpy as jnp

    n, ra, ca, va = _coo(7, n=40, nnz=200, dtype=np.int32, lo=0, hi=10)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    v = np.arange(n, dtype=np.int32)
    out = mul_vector(a, jnp.asarray(v))
    ref = _dense_of(n, ra, ca, va).astype(np.int64) @ v
    assert np.array_equal(np.asarray(out).astype(np.int64), ref)


def test_spgemm_integer_exact():
    n, ra, ca, va = _coo(8, n=40, nnz=150, dtype=np.uint32, lo=0, hi=8)
    _, rb, cb, vb = _coo(9, n=40, nnz=150, dtype=np.uint32, lo=0, hi=8)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    b = CSR.from_coo_arrays((n, n), rb, cb, vb)
    out = mul_sparse(a, b)
    ref = (_dense_of(n, ra, ca, va).astype(np.uint64)
           @ _dense_of(n, rb, cb, vb).astype(np.uint64))
    assert np.array_equal(
        np.asarray(out.todense()).astype(np.uint64), ref)


def test_reductions_and_scalar_integer():
    n, ra, ca, va = _coo(10, dtype=np.uint32)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    assert int(sum_elements(a)) == int(_dense_of(n, ra, ca, va).sum())
    out = mul_scalar(a, np.uint32(3))
    assert out.values.dtype == np.uint32
    assert np.array_equal(np.asarray(out.todense()),
                          _dense_of(n, ra, ca, va) * 3)


def test_u32_reference_bench_recipe_exact():
    """The exact reference bench generator semantics: 1000x1000, random
    (row, col), v = rng % 255 as u32, duplicates summed on finalise
    (``/root/reference/benches/sparse_dense_mul.rs:13-29``), multiplied by
    a dense integer RHS — pinned against a numpy u64 oracle."""
    import jax.numpy as jnp

    n, inserts = 1000, 20_000
    rng = np.random.default_rng(1000)
    rows = rng.integers(0, n, inserts)
    cols = rng.integers(0, n, inserts)
    vals = (rng.integers(0, 2**32, inserts) % 255).astype(np.uint32)
    a = CSR.from_coo_arrays((n, n), rows, cols, vals)
    bd = rng.integers(0, 4, (n, 10)).astype(np.uint32)
    out = spmm(a, jnp.asarray(bd))
    ref = _dense_of(n, rows, cols, vals).astype(np.uint64) @ bd.astype(
        np.uint64)
    assert np.array_equal(np.asarray(out).astype(np.uint64), ref)
