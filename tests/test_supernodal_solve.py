"""Panel-wise triangular solves with the supernodal factor
(models.supernodal_solve) against dense references."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

from basic_sparse_matrix_tpu.models import supernodal as sn
from basic_sparse_matrix_tpu.models.supernodal_solve import (
    build_panel_solve,
    solve_panels,
)
from basic_sparse_matrix_tpu.ops.generators import laplacian_3d
from basic_sparse_matrix_tpu.ops.reorder import (
    nd_permutation,
    permute_symmetric,
    rcm_permutation,
)
from basic_sparse_matrix_tpu.utils import config as C


def _factor(k, ordering):
    a = laplacian_3d(k)
    perm = nd_permutation(a) if ordering == "nd" else rcm_permutation(a)
    a = permute_symmetric(a, perm)
    sched = sn.analyze_supernodal(a, relax=8)
    lvals = sn.factorize_supernodal(sched, a.values)
    l = np.asarray(sn.assemble_factor(a, np.asarray(lvals), sched).todense(),
                   np.float64)
    return a, sched, lvals, l


@pytest.fixture(scope="module", params=["nd", "rcm"])
def factor7(request):
    return _factor(7, request.param)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m", [1, 3])
def test_panel_solve_matches_dense_triangular(factor7, transpose, m):
    a, sched, lvals, l = factor7
    b = np.random.default_rng(m).standard_normal((a.rows, m))
    got = np.asarray(solve_panels(build_panel_solve(sched), lvals,
                                  jnp.asarray(b, jnp.float32),
                                  transpose=transpose))
    ref = sla.solve_triangular(l, b, lower=True, trans=int(transpose))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_panel_schedule_groups_levels(factor7):
    _, sched, _, _ = factor7
    ps = build_panel_solve(sched)
    slevel = sched.panel_parts[4]
    n_levels = sum(lay[0][1][0] for lay in ps.layout)
    assert n_levels == int(slevel.max()) + 1
    assert len(ps.layout) <= n_levels
    for lay in ps.layout:
        for _, shape in lay:
            for d in shape[1:]:
                assert d & (d - 1) == 0        # pow2-rounded


@pytest.mark.parametrize("ordering", ["nd", "rcm"])
def test_direct_solver_supernodal_solves(ordering):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from basic_sparse_matrix_tpu import prepare_direct

    old = C.get_config()
    C.set_config(dataclasses.replace(old, ordering=ordering,
                                     banded_max_block=0))
    try:
        a = laplacian_3d(6)
        solver = prepare_direct(a)
    finally:
        C.set_config(old)
    assert solver.kind == "supernodal"
    ip, ix, v = a.numpy()
    a64 = sp.csr_matrix((v.astype(np.float64), ix, ip),
                        shape=(a.rows, a.cols))
    b = np.random.default_rng(0).standard_normal(a.rows)
    x = np.asarray(solver.solve(jnp.asarray(b, jnp.float32)))
    assert x.shape == (a.rows,)
    ref = spla.spsolve(a64.tocsc(), b)
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-5
