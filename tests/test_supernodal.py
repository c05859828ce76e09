"""Supernodal Cholesky tests — panel numeric phase vs dense oracle."""

import dataclasses

import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.models.supernodal import (
    analyze_supernodal,
    cholesky_supernodal,
    factorize_supernodal,
)


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


def _cases():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((12, 12))
    arrow = np.eye(8, dtype=np.float32) * 5
    arrow[7, :] = 1
    arrow[:, 7] = 1
    arrow[7, 7] = 20
    band = (4 * np.eye(30) - np.eye(30, k=1) - np.eye(30, k=-1)
            - 0.5 * np.eye(30, k=3) - 0.5 * np.eye(30, k=-3))
    return {
        "dense": (m @ m.T + 12 * np.eye(12)).astype(np.float32),
        "tridiag": (4 * np.eye(20) - np.eye(20, k=1)
                    - np.eye(20, k=-1)).astype(np.float32),
        "lap2d": _lap2d(6),
        "arrow": arrow,
        "banded": band.astype(np.float32),
        "reference0": np.asarray(
            [[4.0, 12, -16], [12, 37, -43], [-16, -43, 98]],
            dtype=np.float32),
    }


@pytest.mark.parametrize("name", list(_cases().keys()))
def test_matches_dense_oracle(name):
    a_dense = _cases()[name]
    l = cholesky_supernodal(CSR.from_dense(a_dense))
    ref = np.linalg.cholesky(a_dense.astype(np.float64))
    assert np.allclose(np.asarray(l.todense()), ref, rtol=1e-4, atol=1e-5)


def test_matches_scatter_list_path():
    from basic_sparse_matrix_tpu.models.sparse_cholesky import (
        cholesky_sparse,
    )

    a = CSR.from_dense(_lap2d(5))
    l1 = cholesky_supernodal(a)
    l2 = cholesky_sparse(a)
    assert np.allclose(np.asarray(l1.todense()), np.asarray(l2.todense()),
                       rtol=1e-5, atol=1e-6)


def test_schedule_metadata():
    a = CSR.from_dense(_cases()["dense"])
    sched = analyze_supernodal(a)
    assert sched.avg_panel_width == 12.0  # dense → one panel
    import jax

    lv = np.asarray(jax.device_get(factorize_supernodal(sched, a.values)))
    assert np.isfinite(lv).all()


def test_full_solve_through_supernodal_factor():
    from basic_sparse_matrix_tpu.models.sparse_triangular import (
        solve_triangular_sparse,
    )

    a_dense = _lap2d(5)
    a = CSR.from_dense(a_dense)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((25, 2)).astype(np.float32)
    l = cholesky_supernodal(a)
    y = solve_triangular_sparse(l, b, lower=True)
    x = np.asarray(solve_triangular_sparse(l.transpose(), y, lower=False))
    oracle = np.linalg.solve(a_dense.astype(np.float64), b)
    assert np.allclose(x, oracle, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("relax", [2, 8, 32])
def test_relaxed_amalgamation_correct(relax):
    from basic_sparse_matrix_tpu.ops.reorder import (
        permute_symmetric,
        rcm_permutation,
    )

    a_dense = _lap2d(8)
    a = CSR.from_dense(a_dense)
    ap = permute_symmetric(a, rcm_permutation(a))
    import jax

    sched = analyze_supernodal(ap, relax=relax)
    lv = np.asarray(jax.device_get(factorize_supernodal(sched, ap.values)))
    from basic_sparse_matrix_tpu.models.supernodal import assemble_factor

    l = assemble_factor(ap, lv, sched)
    ref = np.linalg.cholesky(np.asarray(ap.todense()).astype(np.float64))
    assert np.allclose(np.asarray(l.todense()), ref, rtol=1e-4, atol=1e-4)
    if relax >= 8:
        assert sched.avg_panel_width > 2.0  # panels actually amalgamate


def test_relaxed_width_grows_with_budget():
    from basic_sparse_matrix_tpu.ops.reorder import (
        permute_symmetric,
        rcm_permutation,
    )

    a = CSR.from_dense(_lap2d(10))
    ap = permute_symmetric(a, rcm_permutation(a))
    w0 = analyze_supernodal(ap, relax=0).avg_panel_width
    w8 = analyze_supernodal(ap, relax=8).avg_panel_width
    assert w8 > w0


def test_wide_n_int32_tables():
    """n > 65535 keeps int32 row/rank tables (uint16 narrowing only applies
    when every row id and the n sentinel fit); factor stays correct. A
    block-diagonal pattern keeps the schedule one level deep so the test is
    cheap at n = 65544."""
    import jax.numpy as jnp

    blocks, bs = 8193, 8           # 8193 * 8 = 65544 > 0xFFFF
    n = blocks * bs
    rng = np.random.default_rng(3)
    m = rng.standard_normal((bs, bs)).astype(np.float32)
    spd = (m @ m.T + bs * np.eye(bs)).astype(np.float32)
    rr, cc = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    offs = (np.arange(blocks) * bs)[:, None, None]
    rows = (rr[None] + offs).ravel()
    cols = (cc[None] + offs).ravel()
    vals = np.broadcast_to(spd, (blocks, bs, bs)).ravel()
    a = CSR.from_coo_arrays((n, n), rows, cols, vals)

    sched = analyze_supernodal(a)
    assert all(t.dtype == jnp.int32 for t in sched.upd_irows)
    assert all(t.dtype == jnp.int32 for t in sched.upd_jrows)

    lvals = np.asarray(factorize_supernodal(sched, a.values))
    from basic_sparse_matrix_tpu.models.supernodal import assemble_factor

    l = assemble_factor(a, lvals, sched)
    # Check one interior block of L against the dense oracle.
    ref = np.linalg.cholesky(spd.astype(np.float64))
    o = 4096 * bs
    blk = np.asarray(l.take_submatrix((o, o), (o + bs, o + bs)).todense())
    assert np.allclose(blk, ref, rtol=1e-4, atol=1e-5)


def test_small_n_uint16_tables():
    """n <= 65535 narrows row/rank tables to uint16; bitwise-equal factor
    values versus a schedule forced to int32 widths."""
    import jax.numpy as jnp

    a = CSR.from_dense(_lap2d(6))
    sched = analyze_supernodal(a)
    assert all(t.dtype == jnp.uint16 for t in sched.upd_irows)
    assert all(t.dtype == jnp.uint16 for t in sched.upd_ibelow)
    lv16 = np.asarray(factorize_supernodal(sched, a.values))

    # Widen by moving the uint16 tables into the int32 buffer (the packed
    # layout's buffer id 1 -> 0 with rebased offsets).
    base = int(sched.flat_i32.shape[0])
    wide = dataclasses.replace(
        sched,
        flat_i32=jnp.concatenate(
            [sched.flat_i32, sched.flat_u16.astype(jnp.int32)]),
        flat_u16=jnp.zeros((0,), jnp.uint16),
        layout=tuple(
            tuple((0, base + off, shape) if bid == 1 else (bid, off, shape)
                  for bid, off, shape in lay)
            for lay in sched.layout),
    )
    lv32 = np.asarray(factorize_supernodal(wide, a.values))
    assert np.array_equal(lv16, lv32)


def test_chunked_program_execution_matches_whole():
    """Group-chunked execution (supernodal_groups_per_program) is bitwise
    equal to the single-program form."""
    import dataclasses as dc

    from basic_sparse_matrix_tpu.models.supernodal import (
        _factorize_supernodal_whole,
    )
    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    a = CSR.from_dense(_lap2d(7))
    sched = analyze_supernodal(a, relax=4)
    assert len(sched.upd_base) >= 3, "want a multi-group schedule"
    whole = np.asarray(_factorize_supernodal_whole(sched, a.values))
    cfg = get_config()
    try:
        set_config(dc.replace(cfg, supernodal_groups_per_program=2))
        chunked = np.asarray(factorize_supernodal(sched, a.values))
    finally:
        set_config(cfg)
    assert np.array_equal(whole, chunked)


def test_window_gather_matches_element():
    """supernodal_gather="window" (one dynamic-slice issue per contiguous
    run) is bitwise-equal to the element-gather path."""
    import dataclasses as dc

    from basic_sparse_matrix_tpu.models.supernodal import (
        _factorize_supernodal_whole,
    )
    from basic_sparse_matrix_tpu.ops.reorder import (
        nd_permutation,
        permute_symmetric,
    )
    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    for relax in (0, 8):
        a = CSR.from_dense(_lap2d(9))
        ap = permute_symmetric(a, nd_permutation(a))
        sched = analyze_supernodal(ap, relax=relax)
        elem = np.asarray(
            _factorize_supernodal_whole(sched, ap.values, "element"))
        win = np.asarray(
            _factorize_supernodal_whole(sched, ap.values, "window"))
        # identical math; XLA fuses the window masks into the einsum
        # differently, so agreement is to the ulp, not bitwise
        np.testing.assert_allclose(elem, win, rtol=1e-6, atol=1e-8,
                                   err_msg=str(relax))

    # ...and through the public wrapper + chunked programs.
    cfg = get_config()
    try:
        set_config(dc.replace(cfg, supernodal_gather="window",
                              supernodal_groups_per_program=2))
        chunked_win = np.asarray(factorize_supernodal(sched, ap.values))
    finally:
        set_config(cfg)
    assert np.array_equal(chunked_win, win)

    # "auto" (per-group host choice, r4): same factor, whole and chunked;
    # force a mixed choice by lowering the break-even so at least one
    # group takes each path when the schedule allows it.
    auto = np.asarray(
        _factorize_supernodal_whole(sched, ap.values, "auto"))
    np.testing.assert_allclose(elem, auto, rtol=1e-6, atol=1e-8)
    try:
        set_config(dc.replace(cfg, supernodal_gather="auto",
                              supernodal_groups_per_program=2))
        chunked_auto = np.asarray(factorize_supernodal(sched, ap.values))
    finally:
        set_config(cfg)
    assert np.array_equal(chunked_auto, auto)
    # the per-group resolver honours the host table
    from basic_sparse_matrix_tpu.models.supernodal import _group_window
    assert [_group_window(sched, gi, "auto")
            for gi in range(sched.n_groups)] == list(sched.use_window)


def test_delta_scatter_matches_element():
    """supernodal_scatter="delta" (one-hot matmul embedding into target-panel
    rects + one affine rect scatter) produces the same factor as the
    per-element scatter, across orderings, relax levels, and bucketed
    schedules, and composes with window gathers + chunked programs."""
    import dataclasses as dc

    from basic_sparse_matrix_tpu.models.supernodal import (
        _factorize_supernodal_whole,
    )
    from basic_sparse_matrix_tpu.ops.reorder import (
        nd_permutation,
        permute_symmetric,
    )
    from basic_sparse_matrix_tpu.utils.config import get_config, set_config

    cases = []
    for name, a_dense in _cases().items():
        cases.append((name, CSR.from_dense(a_dense), 0))
    big = CSR.from_dense(_lap2d(9))
    big = permute_symmetric(big, nd_permutation(big))
    cases.append(("lap2d9_nd_r0", big, 0))
    cases.append(("lap2d9_nd_r8", big, 8))

    for name, a, relax in cases:
        sched = analyze_supernodal(a, relax=relax)
        elem = np.asarray(_factorize_supernodal_whole(
            sched, a.values, "element", "element"))
        delta = np.asarray(_factorize_supernodal_whole(
            sched, a.values, "element", "delta"))
        # one-hot matmuls copy values exactly; the segment merge sums in
        # a different order than scatter-add, so agreement is to the ulp
        np.testing.assert_allclose(elem, delta, rtol=1e-6, atol=1e-8,
                                   err_msg=name)

    # delta + window + chunked programs through the public wrapper
    sched = analyze_supernodal(big, relax=8)
    ref = np.asarray(_factorize_supernodal_whole(
        sched, big.values, "element", "element"))
    cfg = get_config()
    try:
        set_config(dc.replace(cfg, supernodal_scatter="delta",
                              supernodal_gather="window",
                              supernodal_groups_per_program=2))
        combo = np.asarray(factorize_supernodal(sched, big.values))
    finally:
        set_config(cfg)
    np.testing.assert_allclose(ref, combo, rtol=1e-6, atol=1e-8)


def test_delta_auto_choice_recorded():
    """analyze records a per-group formulation choice and target tables
    whose shapes stack consistently with the group axis."""
    a = CSR.from_dense(_lap2d(8))
    sched = analyze_supernodal(a, relax=4)
    n_g = len(sched.upd_base)
    assert len(sched.use_delta) == n_g
    assert len(sched.delta_rmax) == n_g
    for gi in range(n_g):
        g = sched.upd_base[gi].shape[0]
        assert sched.tgt_cp[gi].shape[0] == g
        assert sched.upd_seg[gi].shape == sched.upd_base[gi].shape[:2]
        assert sched.delta_rmax[gi] >= 1
