"""Algebra op tests ported from the reference (sparse.rs:1083-1323,
1501-1529) plus oracle checks against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR, Dense, IncorrectDimensions
from basic_sparse_matrix_tpu.ops import (
    add_sparse,
    l2_norm,
    mul_dense,
    mul_scalar,
    mul_sparse,
    mul_vector,
    spgemm_bounded,
    spmm,
    spmm_to_csr,
    sub_sparse,
    sum_elements,
)


def test_dense_mul():
    # sparse.rs:1083-1109 — note reference Dense::from_data is column-major
    d = Dense.from_data([
        [1, 2, 3, 4],
        [5, 6, 7, 8],
        [9, 10, 11, 12],
    ])  # 4 rows × 3 cols
    s = CSR.from_dense([
        [3, 0, 2, 0],
        [7, 0, 0, 0],
        [0, 2, 0, 1],
        [0, 0, 1, 0],
        [1, 0, 0, 0],
    ])
    # reference expects a Csr::from_data (row-major) result fixture
    out_ref = np.asarray([
        [9, 29, 49],
        [7, 35, 63],
        [8, 20, 32],
        [3, 7, 11],
        [1, 5, 9],
    ])
    out = mul_dense(s, d.array)
    assert np.array_equal(np.asarray(out), out_ref)


def test_dense_mul_dim_error():
    # mul_dense dim check (sparse.rs:427-429)
    s = CSR.from_dense([[1, 2], [3, 4]])
    with pytest.raises(IncorrectDimensions):
        mul_dense(s, jnp.ones((3, 2)))


def test_nnz_of_product():
    # sparse.rs:1154-1178 — product zeros are dropped in the CSR-shaped result
    m = CSR.from_dense([
        [5, 2, 1, 3],
        [7, 0, 1, 3],
        [0, 1, 0, 0],
        [0, 7, 4, 0],
    ])
    a = Dense.from_data([
        [1, 0, 3, 4],
        [8, 0, 0, 5],
    ])
    out = spmm_to_csr(m, a.array)
    ref = CSR.from_dense([
        [20, 55],
        [22, 71],
        [0, 0],
        [12, 0],
    ])
    assert out.allclose(ref)
    assert out.get_nnz() == 5


def test_add_sparse():
    # sparse.rs:1182-1208
    a = CSR.from_dense([
        [5, 6, 7, 8, 9],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0],
    ])
    b = CSR.from_dense([
        [9, 8, 7, 6, 5],
        [0, 0, 0, 0, 0],
        [1, 0, 0, 0, 0],
        [1, 0, 0, 0, 0],
    ])
    c_ref = CSR.from_dense([
        [14, 14, 14, 14, 14],
        [0, 0, 0, 0, 0],
        [1, 0, 0, 0, 1],
        [2, 0, 0, 0, 0],
    ])
    c = add_sparse(a, b)
    assert c.allclose(c_ref)
    # compacted() restores exact-nnz reference storage semantics
    assert c.compacted().stored == c_ref.stored


def test_sub_sparse():
    # sparse.rs:1211-1237
    a = CSR.from_dense([
        [5, 6, 7, 8, 9],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0],
    ])
    b = CSR.from_dense([
        [9, 8, 7, 6, 5],
        [0, 0, 0, 0, 0],
        [1, 0, 0, 0, 0],
        [1, 0, 0, 0, 0],
    ])
    c_ref = CSR.from_dense([
        [-4, -2, 0, 2, 4],
        [0, 0, 0, 0, 0],
        [-1, 0, 0, 0, 1],
        [0, 0, 0, 0, 0],
    ])
    c = sub_sparse(a, b)
    assert c.allclose(c_ref)


def test_add_dim_error():
    a = CSR.from_dense([[1, 2]])
    b = CSR.from_dense([[1], [2]])
    with pytest.raises(IncorrectDimensions):
        add_sparse(a, b)
    with pytest.raises(IncorrectDimensions):
        sub_sparse(a, b)


def test_sparse_multiplication():
    # sparse.rs:1240-1303 round 3 (active case)
    a = CSR.from_dense([[0], [1], [1]])
    b = a.transpose()
    c = mul_sparse(a, b)
    c_ref = CSR.from_dense([
        [0, 0, 0],
        [0, 1, 1],
        [0, 1, 1],
    ])
    assert c.allclose(c_ref)

    # round 1/2 cases (commented out in the reference but valid algebra)
    a = CSR.from_dense([[1, 3, 5], [3, 7, 9], [5, 9, 11]])
    b = CSR.from_dense([[2, 4, 6], [4, 8, 10], [6, 10, 12]])
    c_ref = CSR.from_dense([[44, 78, 96], [88, 158, 196], [112, 202, 252]])
    assert mul_sparse(a, b).allclose(c_ref)


def test_spgemm_bounded_matches_dense():
    rng = np.random.default_rng(7)
    ad = (rng.random((17, 23)) < 0.2) * rng.integers(1, 9, (17, 23))
    bd = (rng.random((23, 11)) < 0.3) * rng.integers(1, 9, (23, 11))
    a, b = CSR.from_dense(ad.astype(np.float32)), CSR.from_dense(
        bd.astype(np.float32))
    cap_needed = a.stored * int(
        np.max(np.diff(np.asarray(b.indptr)))) if a.stored else 1
    c = spgemm_bounded(a, b, cap_needed)
    assert np.allclose(np.asarray(c.todense()), ad @ bd)


def test_mul_scalar():
    # sparse.rs:1307-1323
    a = CSR.from_dense([
        [1.0, 2.0, 3.0],
        [4.0, 5.0, 6.0],
        [7.0, 8.0, 9.0],
    ])
    b_ref = CSR.from_dense([
        [2.0, 4.0, 6.0],
        [8.0, 10.0, 12.0],
        [14.0, 16.0, 18.0],
    ])
    assert mul_scalar(a, 2.0).allclose(b_ref)


def test_mul_vector():
    # sparse.rs:1501-1529 incl. dimension-error case
    v = jnp.arange(5)
    m = CSR.from_dense(np.zeros((3, 4)))
    with pytest.raises(IncorrectDimensions):
        mul_vector(m, v)

    m = CSR.from_dense(np.eye(5, dtype=np.int32))
    out = mul_vector(m, v)
    assert np.array_equal(np.asarray(out), np.arange(5))

    m = CSR.from_dense([
        [1, 0, 2, 0, 3],
        [0, 1, 0, 2, 0],
    ])
    out = mul_vector(m, v)
    assert np.asarray(out).tolist() == [16, 7]


def test_sum_elements_l2():
    # sparse.rs:637-643, 678-680
    a = CSR.from_dense([[3.0, 0.0], [0.0, 4.0]])
    assert float(sum_elements(a)) == 7.0
    assert float(l2_norm(a)) == pytest.approx(5.0)


def test_spmm_random_oracle():
    rng = np.random.default_rng(42)
    ad = (rng.random((50, 70)) < 0.1) * rng.standard_normal((50, 70))
    bd = rng.standard_normal((70, 9))
    out = spmm(CSR.from_dense(ad.astype(np.float32)),
               jnp.asarray(bd, dtype=jnp.float32))
    assert np.allclose(np.asarray(out), ad @ bd, rtol=1e-4, atol=1e-4)


def test_add_random_oracle():
    rng = np.random.default_rng(3)
    ad = (rng.random((30, 40)) < 0.15) * rng.integers(1, 9, (30, 40))
    bd = (rng.random((30, 40)) < 0.15) * rng.integers(1, 9, (30, 40))
    c = add_sparse(CSR.from_dense(ad), CSR.from_dense(bd))
    assert np.array_equal(np.asarray(c.todense()), ad + bd)
    c = sub_sparse(CSR.from_dense(ad), CSR.from_dense(bd))
    assert np.array_equal(np.asarray(c.todense()), ad - bd)


def test_spgemm_planned_matches_scipy():
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.ops.spgemm import spgemm_planned

    A = sp.random(70, 50, 0.12, random_state=3, format="csr",
                  dtype=np.float32)
    B = sp.random(50, 80, 0.12, random_state=4, format="csr",
                  dtype=np.float32)
    a = CSR.from_coo_arrays(A.shape, A.tocoo().row, A.tocoo().col,
                            A.tocoo().data)
    b = CSR.from_coo_arrays(B.shape, B.tocoo().row, B.tocoo().col,
                            B.tocoo().data)
    out = spgemm_planned(a, b)
    out2 = spgemm_planned(a, b)  # memoised plan path
    ref = (A @ B).toarray()
    assert np.allclose(np.asarray(out.todense()), ref, rtol=1e-4, atol=1e-5)
    assert np.allclose(np.asarray(out2.todense()), ref, rtol=1e-4, atol=1e-5)


def test_spgemm_planned_skewed_b_dense_row():
    """The round-1 bounded path needed nnz(A)·max_row(B) capacity — one
    dense row in B blew the budget. The planned path sizes by actual
    matched lengths."""
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.ops.spgemm import spgemm_planned

    n = 3000
    rng = np.random.default_rng(7)
    nnz = 9000
    ra, ca = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    va = rng.standard_normal(nnz).astype(np.float32)
    rb = np.concatenate([np.arange(n), np.full(n, 17)])
    cb = np.concatenate([np.arange(n), np.arange(n)])
    vb = rng.standard_normal(2 * n).astype(np.float32)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    b = CSR.from_coo_arrays((n, n), rb, cb, vb)
    out = spgemm_planned(a, b)
    A = sp.coo_matrix((va, (ra, ca)), shape=(n, n)).tocsr()
    B = sp.coo_matrix((vb, (rb, cb)), shape=(n, n)).tocsr()
    ip, ix, vv = out.numpy()
    C = sp.csr_matrix((vv, ix, ip), shape=(n, n))
    assert abs(C - A @ B).max() < 1e-4


def test_spgemm_planned_chunked_over_budget(monkeypatch):
    """Expansion beyond EXPANSION_BUDGET no longer refuses: the planner
    falls back to contiguous row chunks executed independently. Budget is shrunk so the chunked path triggers at test scale —
    same code path as a real >2^27 expansion, minus the wait."""
    import scipy.sparse as sp

    import importlib

    sg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")

    n = 400
    rng = np.random.default_rng(11)
    nnz = 6000
    ra, ca = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    va = rng.standard_normal(nnz).astype(np.float32)
    rb, cb = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vb = rng.standard_normal(nnz).astype(np.float32)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    b = CSR.from_coo_arrays((n, n), rb, cb, vb)
    # Actual expansion at this recipe is ~nnz^2/n = 90k; force chunking.
    monkeypatch.setattr(sg, "EXPANSION_BUDGET", 8_000)
    out = sg.spgemm_planned(a, b)
    out2 = sg.spgemm_planned(a, b)  # memoised chunked plan path
    plan = a._spgemm_plans[-1][1]
    assert isinstance(plan, sg._SpgemmChunkedPlan)
    assert len(plan.chunks) > 1
    A = sp.coo_matrix((va, (ra, ca)), shape=(n, n)).tocsr()
    B = sp.coo_matrix((vb, (rb, cb)), shape=(n, n)).tocsr()
    for o in (out, out2):
        ip, ix, vv = o.numpy()
        C = sp.csr_matrix((vv, ix, ip), shape=(n, n))
        assert abs(C - A @ B).max() < 1e-4


def test_spgemm_planned_chunked_single_row_over_budget(monkeypatch):
    """A single row whose own expansion exceeds the budget stands alone as
    a chunk (soft guard) instead of raising."""
    import scipy.sparse as sp

    import importlib

    sg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")

    n = 100
    rng = np.random.default_rng(5)
    # Row 0 of A is fully dense; B has 20 entries per row → row-0 expansion
    # = 2000, far over the shrunk budget.
    ra = np.concatenate([np.zeros(n, np.int64),
                         rng.integers(1, n, 50)])
    ca = np.concatenate([np.arange(n), rng.integers(0, n, 50)])
    va = rng.standard_normal(n + 50).astype(np.float32)
    rb = np.repeat(np.arange(n), 20)
    cb = rng.integers(0, n, 20 * n)
    vb = rng.standard_normal(20 * n).astype(np.float32)
    a = CSR.from_coo_arrays((n, n), ra, ca, va)
    b = CSR.from_coo_arrays((n, n), rb, cb, vb)
    monkeypatch.setattr(sg, "EXPANSION_BUDGET", 500)
    out = sg.spgemm_planned(a, b)
    A = sp.coo_matrix((va, (ra, ca)), shape=(n, n)).tocsr()
    B = sp.coo_matrix((vb, (rb, cb)), shape=(n, n)).tocsr()
    ip, ix, vv = out.numpy()
    C = sp.csr_matrix((vv, ix, ip), shape=(n, n))
    assert abs(C - A @ B).max() < 1e-4


def test_add_traced_operands_dispatch():
    """Under jit the operands are traced: the merge must route to the
    key-space/lexsort paths (no host plan) and still be exact."""
    import jax

    from basic_sparse_matrix_tpu.ops.elementwise import add, sub

    rng = np.random.default_rng(11)
    a = CSR.from_coo_arrays((40, 40), rng.integers(0, 40, 200),
                            rng.integers(0, 40, 200),
                            rng.standard_normal(200).astype(np.float32))
    b = CSR.from_coo_arrays((40, 40), rng.integers(0, 40, 150),
                            rng.integers(0, 40, 150),
                            rng.standard_normal(150).astype(np.float32))

    @jax.jit
    def f(x, y):
        return add(x, y).todense(), sub(x, y).todense()

    s, d = f(a, b)
    da, db = np.asarray(a.todense()), np.asarray(b.todense())
    assert np.allclose(np.asarray(s), da + db, atol=1e-5)
    assert np.allclose(np.asarray(d), da - db, atol=1e-5)


def test_add_keyspace_large_shape_falls_back():
    """Shapes whose cell space exceeds the accumulator budget must use the
    lexsort merge under tracing (no int32 overflow, no giant alloc)."""
    from basic_sparse_matrix_tpu.ops import elementwise as ew

    rng = np.random.default_rng(12)
    big = (200_000, 200_000)  # 4e10 cells > int32 range
    a = CSR.from_coo_arrays(big, rng.integers(0, big[0], 100),
                            rng.integers(0, big[1], 100),
                            rng.standard_normal(100).astype(np.float32))
    b = CSR.from_coo_arrays(big, rng.integers(0, big[0], 100),
                            rng.integers(0, big[1], 100),
                            rng.standard_normal(100).astype(np.float32))
    assert not ew._use_keyspace(a, b)
    out = ew.add(a, b)  # planned path (concrete) — must handle big shapes
    assert out.shape == big
    ia, xa, va = a.numpy()
    ib, xb, vb = b.numpy()
    io, xo, vo = out.numpy()
    import scipy.sparse as sp

    A = sp.csr_matrix((va, xa, ia), shape=big)
    B = sp.csr_matrix((vb, xb, ib), shape=big)
    C = sp.csr_matrix((vo, xo, io), shape=big)
    assert abs(C - (A + B)).max() < 1e-6


def test_chained_adds_with_padded_intermediate():
    """add(add(a,b), c): the inner result carries capacity padding /
    duplicate coordinates — the planned merge must refuse it (gather maps
    lose duplicates) and the fallback path must stay exact. Round-2
    self-review regression."""
    from basic_sparse_matrix_tpu.ops.elementwise import add

    rng = np.random.default_rng(21)

    def rand(seed, nnz=120):
        r = np.random.default_rng(seed)
        # force a stored entry at (29, 29): the padded merge parks its
        # fill slots there, so a real value at that coordinate is exactly
        # what the buggy gather map overwrote
        rows = np.concatenate([r.integers(0, 30, nnz), [29]])
        cols = np.concatenate([r.integers(0, 30, nnz), [29]])
        vals = np.concatenate(
            [r.standard_normal(nnz), [1.5]]).astype(np.float32)
        return CSR.from_coo_arrays((30, 30), rows, cols, vals)

    a, b, c = rand(1), rand(2), rand(3)
    inner = add(a, b)
    # the padded intermediate really does carry duplicate coords
    ii, ix, _ = inner.numpy()
    rr = np.repeat(np.arange(30), np.diff(ii))
    keys = rr.astype(np.int64) * 30 + ix
    assert np.unique(keys).size != keys.size
    out = add(inner, c)
    ref = (np.asarray(a.todense()) + np.asarray(b.todense())
           + np.asarray(c.todense()))
    assert np.allclose(np.asarray(out.todense()), ref, atol=1e-5)
    out2 = add(c, inner)  # duplicate coords on the right operand
    assert np.allclose(np.asarray(out2.todense()), ref, atol=1e-5)


def test_merge_chunked_matches_planned():
    # issue-coalesced numeric phase vs the shipping two-gather phase
    import numpy as np

    from basic_sparse_matrix_tpu.ops import elementwise as ew
    from basic_sparse_matrix_tpu.ops.csr import CSR

    rng = np.random.default_rng(11)
    for rows, cols, da, db in ((50, 40, 0.1, 0.07), (97, 13, 0.3, 0.0),
                               (8, 8, 0.9, 0.9)):
        A = ((rng.random((rows, cols)) < da)
             * rng.standard_normal((rows, cols))).astype(np.float32)
        B = ((rng.random((rows, cols)) < db)
             * rng.standard_normal((rows, cols))).astype(np.float32)
        a, b = CSR.from_dense(A), CSR.from_dense(B)
        if a.stored + b.stored == 0:
            continue
        plan = ew._MergePlan(a, b)
        ref = ew._merge_planned_vals(
            a.values, b.values, (plan.gather_a, plan.gather_b), plan.n, -1)
        ch = ew._ChunkedMergePlan(plan, a.stored, b.stored, w=16)
        got = ew._merge_chunked_vals(
            a.values, b.values, (ch.c_a, ch.l_a, ch.c_b, ch.l_b),
            plan.n, -1, ch.w)
        assert np.allclose(np.asarray(got), np.asarray(ref), atol=0), (
            rows, cols, da, db)


def test_merge_numeric_config_switch(monkeypatch):
    import numpy as np

    from basic_sparse_matrix_tpu.ops import elementwise as ew
    from basic_sparse_matrix_tpu.ops.csr import CSR
    from basic_sparse_matrix_tpu.utils import config as cfgmod

    rng = np.random.default_rng(12)
    A = ((rng.random((60, 60)) < 0.1)
         * rng.standard_normal((60, 60))).astype(np.float32)
    B = ((rng.random((60, 60)) < 0.1)
         * rng.standard_normal((60, 60))).astype(np.float32)
    a, b = CSR.from_dense(A), CSR.from_dense(B)
    ref = np.asarray(ew.add(a, b).todense())
    import dataclasses

    monkeypatch.setattr(
        cfgmod, "_config",
        dataclasses.replace(cfgmod.get_config(), merge_numeric="chunked"))
    a2 = CSR.from_dense(A)  # fresh plan cache
    got = np.asarray(ew.add(a2, b).todense())
    assert np.allclose(got, ref, atol=0)
    assert np.allclose(got, A + B, rtol=1e-6, atol=1e-6)


def _spgemm_coal_operands(rows=500, b_row_len=64, nnz_a=1000, seed=11):
    """Operands whose matched B rows are uniformly long, so the coalesced
    numeric maps apply (every expansion chunk intersects <= 2 runs)."""
    rng = np.random.default_rng(seed)
    ra = rng.integers(0, rows, nnz_a)
    ca = rng.integers(0, rows, nnz_a)
    va = rng.standard_normal(nnz_a).astype(np.float32)
    rb = np.repeat(np.arange(rows), b_row_len)
    cb = np.concatenate([
        rng.choice(rows, b_row_len, replace=False) for _ in range(rows)])
    vb = rng.standard_normal(rows * b_row_len).astype(np.float32)
    a = CSR.from_coo_arrays((rows, rows), ra, ca, va)
    b = CSR.from_coo_arrays((rows, rows), rb, cb, vb)
    return a, b


def test_spgemm_coalesced_matches_planned():
    """Issue-coalesced numeric phase (spgemm_numeric=chunked) is exact
    against the two-gather path and a scipy oracle."""
    import dataclasses as dc

    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.ops.spgemm import (
        _plan_numeric,
        _SpgemmPlan,
    )
    from basic_sparse_matrix_tpu.utils.config import (
        get_config,
        set_config,
    )

    a, b = _spgemm_coal_operands()
    plan = _SpgemmPlan(a, b)
    assert plan.coal is not None, "operands should be coalescible"

    cfg = get_config()
    try:
        set_config(dc.replace(cfg, spgemm_numeric="planned"))
        v_planned = np.asarray(_plan_numeric(plan, a.values, b.values))
        set_config(dc.replace(cfg, spgemm_numeric="chunked"))
        v_chunked = np.asarray(_plan_numeric(plan, a.values, b.values))
    finally:
        set_config(cfg)

    assert np.allclose(v_planned, v_chunked, rtol=1e-6, atol=1e-7)

    ia, xa, va = a.numpy()
    ib, xb, vb = b.numpy()
    A = sp.csr_matrix((va, xa, ia), shape=(a.rows, a.cols))
    B = sp.csr_matrix((vb, xb, ib), shape=(b.rows, b.cols))
    C = sp.csr_matrix((v_chunked, np.asarray(plan.indices),
                       np.asarray(plan.indptr)), shape=(a.rows, b.cols))
    assert abs(C - A @ B).max() < 1e-4


def test_spgemm_coalesced_fallback_short_rows():
    """Short matched B rows (runs << w) make chunks span > 2 runs: the
    plan must decline to coalesce and the chunked config must silently
    use the standard maps."""
    import dataclasses as dc

    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.ops.spgemm import _SpgemmPlan, spgemm_planned
    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    rng = np.random.default_rng(5)
    rows, nnz_a = 4000, 20000
    ra, ca = rng.integers(0, rows, nnz_a), rng.integers(0, rows, nnz_a)
    va = rng.standard_normal(nnz_a).astype(np.float32)
    # B: ~2 entries per row → runs of ~2 << w
    rb, cb = rng.integers(0, rows, 2 * rows), rng.integers(0, rows, 2 * rows)
    vb = rng.standard_normal(2 * rows).astype(np.float32)
    a = CSR.from_coo_arrays((rows, rows), ra, ca, va)
    b = CSR.from_coo_arrays((rows, rows), rb, cb, vb)
    plan = _SpgemmPlan(a, b)
    assert plan.expansion >= (1 << 14)   # big enough to want coalescing
    assert plan.coal is None             # ...but too short-run to get it

    cfg = get_config()
    try:
        set_config(dc.replace(cfg, spgemm_numeric="chunked"))
        out = spgemm_planned(a, b)
    finally:
        set_config(cfg)
    ip, ix, vv = out.numpy()
    A = sp.coo_matrix((va, (ra, ca)), shape=(rows, rows)).tocsr()
    B = sp.coo_matrix((vb, (rb, cb)), shape=(rows, rows)).tocsr()
    C = sp.csr_matrix((vv, ix, ip), shape=(rows, rows))
    assert abs(C - A @ B).max() < 1e-4


def test_spgemm_mergetree_matches_planned():
    """The merge-tree numeric phase (config spgemm_numeric="mergetree" —
    coalesced source products + log2(k) pairwise sorted-stream merge
    rounds) produces the planned path's values on
    long-row operands, across duplicate-heavy and uneven-k shapes; the
    public wrapper routes through it under the config."""
    import dataclasses as dc
    import importlib

    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    sg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")

    def gen(n, nnz_a, b_row_len, seed):
        r = np.random.default_rng(seed)
        ra, ca = r.integers(0, n, nnz_a), r.integers(0, n, nnz_a)
        va = r.standard_normal(nnz_a).astype(np.float32)
        rb = np.repeat(np.arange(n), b_row_len)
        cb = r.integers(0, n, n * b_row_len)
        vb = r.standard_normal(n * b_row_len).astype(np.float32)
        return (CSR.from_coo_arrays((n, n), ra, ca, va),
                CSR.from_coo_arrays((n, n), rb, cb, vb))

    for n, nnz_a, blen, seed in [(1500, 3000, 64, 1), (400, 2400, 64, 3),
                                 (1000, 2000, 48, 4)]:
        a, b = gen(n, nnz_a, blen, seed)
        plan = sg._SpgemmPlan(a, b)
        mt = plan.mergetree
        assert mt is not None, (n, nnz_a, blen)
        ref = np.asarray(sg._spgemm_planned_vals(
            a.values, b.values, (plan.dst, plan.src_a, plan.src_b),
            plan.nnz_c))
        coal = plan.coal
        maps = ((coal["c1"], coal["c2"], coal["e1"], coal["e2"],
                 coal["boundary"], coal["local"]), mt.rounds)
        got = np.asarray(sg._spgemm_mergetree_vals(
            a.values, b.values, maps, mt.sizes, plan.nnz_c, mt.w))
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9)
        assert err < 1e-5, (n, nnz_a, blen, err)

    # Public wrapper under the config + scipy oracle.
    a, b = gen(1500, 3000, 64, 9)
    cfg = get_config()
    try:
        set_config(dc.replace(cfg, spgemm_numeric="mergetree"))
        out = sg.spgemm_planned(a, b)
    finally:
        set_config(cfg)
    ip, ix, vv = out.numpy()
    C = sp.csr_matrix((vv, ix, ip), shape=(1500, 1500))
    ipa, ixa, va_ = a.numpy()
    ipb, ixb, vb_ = b.numpy()
    A = sp.csr_matrix((va_, ixa, ipa), shape=(1500, 1500))
    B = sp.csr_matrix((vb_, ixb, ipb), shape=(1500, 1500))
    assert abs(C - A @ B).max() < 1e-3


def test_spgemm_mergetree_falls_back_on_short_rows():
    """Short matched B rows violate the 2-runs-per-chunk condition; the
    mergetree plan returns None and the config path falls back to
    planned."""
    import dataclasses as dc
    import importlib

    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    sg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")

    n = 800
    rng = np.random.default_rng(5)
    nnz = 24000  # ~30/row: matched rows far below the chunk width
    a = CSR.from_coo_arrays((n, n), rng.integers(0, n, nnz),
                            rng.integers(0, n, nnz),
                            rng.standard_normal(nnz).astype(np.float32))
    b = CSR.from_coo_arrays((n, n), rng.integers(0, n, nnz),
                            rng.integers(0, n, nnz),
                            rng.standard_normal(nnz).astype(np.float32))
    cfg = get_config()
    try:
        set_config(dc.replace(cfg, spgemm_numeric="mergetree"))
        out = sg.spgemm_planned(a, b)
    finally:
        set_config(cfg)
    ip, ix, vv = out.numpy()
    C = sp.csr_matrix((vv, ix, ip), shape=(n, n))
    ipa, ixa, va_ = a.numpy()
    ipb, ixb, vb_ = b.numpy()
    A = sp.csr_matrix((va_, ixa, ipa), shape=(n, n))
    B = sp.csr_matrix((vb_, ixb, ipb), shape=(n, n))
    assert abs(C - A @ B).max() < 1e-3


def test_spgemm_rowgather_matches_planned():
    """The row-gather numeric phase (config spgemm_numeric="rowgather" —
    padded B-ELL products via one row gather per A entry + one
    destination permutation) produces the planned path's values on
    uniform-B and ragged-B operands; the public wrapper routes through it
    under the config and falls back on skewed B."""
    import dataclasses as dc
    import importlib

    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    sg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")

    def gen(n, nnz_a, b_row_len, seed, ragged=False):
        r = np.random.default_rng(seed)
        ra, ca = r.integers(0, n, nnz_a), r.integers(0, n, nnz_a)
        va = r.standard_normal(nnz_a).astype(np.float32)
        if ragged:
            lens = r.integers(b_row_len // 2, b_row_len + 1, n)
            rb = np.repeat(np.arange(n), lens)
            cb = r.integers(0, n, rb.shape[0])
        else:
            # distinct columns per row — duplicate (row, col) inserts
            # dedup in from_coo_arrays and would break uniformity
            rb = np.repeat(np.arange(n), b_row_len)
            cb = ((np.arange(b_row_len)[None, :] * 7
                   + r.integers(0, n, (n, 1))) % n).ravel()
        vb = r.standard_normal(rb.shape[0]).astype(np.float32)
        return (CSR.from_coo_arrays((n, n), ra, ca, va),
                CSR.from_coo_arrays((n, n), rb, cb, vb))

    for n, nnz_a, blen, seed, ragged in [
            (1500, 3000, 64, 1, False), (400, 2400, 64, 3, True),
            (1000, 2000, 48, 4, True)]:
        a, b = gen(n, nnz_a, blen, seed, ragged)
        plan = sg._SpgemmPlan(a, b)
        rg = plan.rowg
        assert rg is not None, (n, nnz_a, blen)
        assert rg["uniform"] == (not ragged)
        ref = np.asarray(sg._spgemm_planned_vals(
            a.values, b.values, (plan.dst, plan.src_a, plan.src_b),
            plan.nnz_c))
        got = np.asarray(sg._spgemm_rowgather_vals(
            a.values, b.values,
            (rg["xa"], rg["ell_map"], rg["perm"], plan.dst),
            plan.nnz_c, rg["wB"], rg["uniform"]))
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9)
        assert err < 1e-5, (n, nnz_a, blen, err)

    # Public wrapper under the config + scipy oracle.
    a, b = gen(1500, 3000, 64, 9)
    cfg = get_config()
    try:
        set_config(dc.replace(cfg, spgemm_numeric="rowgather"))
        out = sg.spgemm_planned(a, b)
    finally:
        set_config(cfg)
    ip, ix, vv = out.numpy()
    C = sp.csr_matrix((vv, ix, ip), shape=(1500, 1500))
    ipa, ixa, va_ = a.numpy()
    ipb, ixb, vb_ = b.numpy()
    A = sp.csr_matrix((va_, ixa, ipa), shape=(1500, 1500))
    B = sp.csr_matrix((vb_, ixb, ipb), shape=(1500, 1500))
    assert abs(C - A @ B).max() < 1e-3

    # Skewed B (one dense row): the ELL pad blows the overhead budget,
    # rowg is None, and the config path falls back to planned.
    r = np.random.default_rng(11)
    n = 2000
    ra, ca = r.integers(0, n, 40_000), r.integers(0, n, 40_000)
    va = r.standard_normal(40_000).astype(np.float32)
    rb = np.concatenate([np.zeros(n, np.int64),
                         r.integers(1, n, 4000)])
    cb = np.concatenate([np.arange(n), r.integers(0, n, 4000)])
    vb = r.standard_normal(rb.shape[0]).astype(np.float32)
    a2 = CSR.from_coo_arrays((n, n), ra, ca, va)
    b2 = CSR.from_coo_arrays((n, n), rb, cb, vb)
    plan2 = sg._SpgemmPlan(a2, b2)
    assert plan2.rowg is None
    try:
        set_config(dc.replace(cfg, spgemm_numeric="rowgather"))
        out2 = sg.spgemm_planned(a2, b2)
    finally:
        set_config(cfg)
    ip2, ix2, vv2 = out2.numpy()
    C2 = sp.csr_matrix((vv2, ix2, ip2), shape=(n, n))
    A2 = sp.csr_matrix((va, (ra, ca)), shape=(n, n))
    B2 = sp.csr_matrix((vb, (rb, cb)), shape=(n, n))
    assert abs(C2 - A2 @ B2).max() < 1e-3
