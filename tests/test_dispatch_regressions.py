"""Regression test for a dispatcher bug: ``cholesky_auto``'s supernodal
branch assembled the factor WITHOUT the schedule: with
``supernodal_relax > 0`` the analyzed pattern is expanded, so the values
misaligned with the rebuilt unexpanded pattern and a silently wrong factor
came back. These tests shrink ``dense_cholesky_max_n`` so the supernodal
branch actually executes and assert against the dense oracle.
"""

import dataclasses

import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.utils import config as _cfg


@pytest.fixture
def small_dense_threshold():
    """Shrink the dense-Cholesky cutoffs so auto dispatch reaches the sparse
    branches at test-sized matrices, restoring config afterwards."""
    old = _cfg.get_config()
    _cfg.set_config(dataclasses.replace(
        old, dense_cholesky_max_n=16, dense_cholesky_min_density=1.1))
    yield
    _cfg.set_config(old)


def _lap2d(k):
    n = k * k
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            r = i * k + j
            a[r, r] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < k and 0 <= jj < k:
                    a[r, ii * k + jj] = -1.0
    return a


@pytest.mark.parametrize("k", [8, 12])
def test_cholesky_auto_supernodal_branch_correct(small_dense_threshold, k):
    """cholesky_auto through the supernodal (amalgamated, relax>0) branch
    must match the dense factor — the round-1 bug silently truncated."""
    from basic_sparse_matrix_tpu.models.cholesky import cholesky_auto
    from basic_sparse_matrix_tpu.models.supernodal import analyze_supernodal
    from basic_sparse_matrix_tpu.ops.reorder import (
        permute_symmetric,
        rcm_permutation,
    )

    a = CSR.from_dense(_lap2d(k))
    a = permute_symmetric(a, rcm_permutation(a))
    # Precondition for the regression: the branch actually runs AND the
    # relaxed pattern is genuinely expanded vs relax=0.
    cfg = _cfg.get_config()
    assert a.rows > cfg.dense_cholesky_max_n
    sched = analyze_supernodal(a, relax=cfg.supernodal_relax)
    assert sched.avg_panel_width >= 2.0
    assert sched.nnz_l > analyze_supernodal(a, relax=0).nnz_l

    l = cholesky_auto(a)
    ref = np.linalg.cholesky(np.asarray(a.todense()).astype(np.float64))
    assert np.allclose(np.asarray(l.todense()), ref, rtol=1e-4, atol=1e-4)


def test_assemble_factor_rejects_mismatched_values():
    from basic_sparse_matrix_tpu.models import supernodal as _sn

    a = CSR.from_dense(_lap2d(6))
    sched = _sn.analyze_supernodal(a, relax=8)
    import jax

    lvals = np.asarray(
        jax.device_get(_sn.factorize_supernodal(sched, a.values)))
    if lvals.shape[0] == _sn.analyze_supernodal(a, relax=0).nnz_l:
        pytest.skip("pattern did not expand at this size")
    with pytest.raises(ValueError, match="does not match"):
        _sn.assemble_factor(a, lvals)  # sched-less rebuild must not truncate
