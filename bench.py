"""Benchmark harness — prints ONE JSON line.

Replays the reference's headline criterion workload ``sd_mul``
(``/root/reference/benches/sparse_dense_mul.rs:6-35``): a 1000×1000 sparse
matrix at the largest sweep point (900k random inserts, duplicates kept —
exactly the reference generator's semantics, which pushes random (row,col)
pairs through ``insert`` without dedup) multiplied by a dense RHS widened
from the reference's 10 columns to 128; throughput is normalised per
inserted element like criterion's ``Throughput::Elements``. The line also
carries sparse-kernel and solver sub-metrics.

Runs on the GPU only (raises elsewhere). The workload is generated on
device, and the sd_mul step runs the library's own dispatch (``spmm_auto``,
which takes the dense matmul at this density). ``vs_baseline`` is the
achieved fraction of a measured same-shape dense matmul at HIGHEST
precision; roofline fractions divide by the device's entry in
``runtime.profiling.PEAKS``.
"""

import json
import time

N = 1000
INSERTS = 900_000
N_RHS = 128
SEED = 1000



def main():
    import sys as _sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.default_backend() != "gpu":
        raise RuntimeError("bench.py measures the GPU; JAX's backend is "
                           f"{jax.default_backend()!r}")
    from basic_sparse_matrix_tpu.runtime.cache import enable_compile_cache
    from basic_sparse_matrix_tpu.runtime.profiling import peak_spec

    enable_compile_cache()
    HBM_BW = peak_spec().hbm_bw

    _t0 = time.time()
    _t_last = [_t0]
    _ticks_on = bool(__import__("os").environ.get("BSM_BENCH_TICKS"))

    def _tick(label):
        # stderr section timing, opt-in via BSM_BENCH_TICKS=1 (the stdout
        # contract is ONE json line; keep the driver-visible stream
        # identical to prior rounds by default)
        if not _ticks_on:
            return
        now = time.time()
        print(f"[bench] {label}: +{now - _t_last[0]:.1f}s "
              f"(total {now - _t0:.1f}s)", file=_sys.stderr, flush=True)
        _t_last[0] = now

    @jax.jit
    def make_workload(key):
        krow, kcol, kval, kb = jax.random.split(key, 4)
        rows = jax.random.randint(krow, (INSERTS,), 0, N, dtype=jnp.int32)
        cols = jax.random.randint(kcol, (INSERTS,), 0, N, dtype=jnp.int32)
        vals = jax.random.randint(kval, (INSERTS,), 0, 255,
                                  dtype=jnp.int32).astype(jnp.float32)
        order = jnp.argsort(rows * N + cols, stable=True)
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = jnp.zeros(N, dtype=jnp.int32).at[rows].add(1)
        indptr = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
        )
        b = jax.random.randint(kb, (N, N_RHS), 0, 255,
                               dtype=jnp.int32).astype(jnp.float32)
        return indptr, rows, cols, vals, b

    key = jax.random.PRNGKey(SEED)
    indptr, rows, cols, vals, b = jax.block_until_ready(make_workload(key))

    from basic_sparse_matrix_tpu import CSR as _CSR
    from basic_sparse_matrix_tpu.ops import spmm_auto
    from basic_sparse_matrix_tpu.utils.config import matmul_precision

    # The library dispatch at this density is the dense matmul against the
    # memoised densified operand; densify once outside the timed region,
    # where the reference bench keeps construction
    # (benches/sparse_dense_mul.rs:13-29 builds outside b.iter).
    sd_csr = _CSR(indptr=indptr, indices=cols, values=vals, rows=N, cols=N)
    jax.block_until_ready(spmm_auto(sd_csr, b))
    a_dense = sd_csr._dense_cache
    prec = matmul_precision()

    def run(ad, bb):
        return jnp.dot(ad, bb, precision=prec)

    operand = a_dense

    # Iterate ON DEVICE with serialised (normalised-feedback) iterations at
    # two different counts and take the difference — the fixed
    # per-execution cost cancels exactly.
    import functools

    @functools.partial(jax.jit, static_argnums=(2,))
    def run_many(operand, bb, inner):
        # Honest serialisation: each iteration's input is the previous
        # normalised output — full-magnitude, full-rank feedback that cannot
        # be strength-reduced, rounded away in bf16, or pipelined across
        # iterations.
        def step(_, carry):
            out = run(operand, carry)
            return out * (1.0 / jnp.maximum(jnp.max(jnp.abs(out)), 1e-30))
        return jax.lax.fori_loop(0, inner, step, bb)

    fence = jax.block_until_ready

    def measure(fn, *args, i1=1000, i2=17000, reps=6):
        fence(fn(*args, i1))  # compile both variants + warm the fetch path
        fence(fn(*args, i2))
        t = {}
        for inner in (i1, i2):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fence(fn(*args, inner))
                best = min(best, time.perf_counter() - t0)
            t[inner] = best
        return max(t[i2] - t[i1], 1e-12) / (i2 - i1)

    dt = measure(run_many, operand, b)

    # Measured speed-of-light: the same harness driving a plain dense
    # matmul of identical shape at the same precision.
    a_sol = jnp.ones((N, N), jnp.float32)

    @functools.partial(jax.jit, static_argnums=(2,))
    def sol_many(ad, bb, inner):
        def step(_, carry):
            out = jnp.dot(ad, carry, precision=prec)
            return out * (1.0 / jnp.maximum(jnp.max(jnp.abs(out)), 1e-30))
        return jax.lax.fori_loop(0, inner, step, bb)

    dt_sol = measure(sol_many, a_sol, b)

    elements_per_s = INSERTS / dt
    vs = dt_sol / dt  # fraction of measured dense speed-of-light

    # ---- sparse-kernel sub-metrics (library paths, regress if they do) ----
    from basic_sparse_matrix_tpu.ops.ell import ELL, spmm_ell
    from basic_sparse_matrix_tpu.runtime.timing import make_loop, measure_loop

    hrows, hper, hrhs = 100_000, 32, 512
    hnnz = hrows * hper

    @jax.jit
    def make_hyper(key):
        kc, kv, kb = jax.random.split(key, 3)
        return (jax.random.randint(kc, (hrows, hper), 0, hrows, jnp.int32),
                jax.random.normal(kv, (hrows, hper), jnp.float32),
                jax.random.normal(kb, (hrows, hrhs), jnp.float32))

    hcols, hvals, hb = make_hyper(jax.random.PRNGKey(1))

    def hyper_step(operand, carry):
        c, v = operand
        return spmm_ell(ELL(cols=c, vals=v, n_cols=hrows), carry)

    hdt = measure_loop(make_loop(hyper_step), (hcols, hvals), hb,
                       i1=3, i2=13, reps=2)
    _tick("hypersparse_ell")
    h_bytes = hnnz * 8 + hnnz * hrhs * 4 + hrows * hrhs * 4
    h_frac = (h_bytes / HBM_BW) / hdt

    # Measured random-gather reference: the naive single-gather
    # formulation of the same access pattern the hypersparse kernel is made
    # of — one (hnnz, hrhs) row gather, reduced in place so no full-size
    # temp is written (traffic ≈ the gathered bytes only).
    gidx = hcols.reshape(-1)  # (hnnz,) random rows in [0, hrows)

    def gather_step(operand, carry):
        s = carry[operand].sum(axis=1)            # fused gather+reduce
        return carry + s.sum() * 1e-30

    gdt = measure_loop(make_loop(gather_step), gidx, hb, i1=2, i2=8, reps=2)
    _tick("gather_probe")
    gather_gbps = hnnz * hrhs * 4 / gdt / 1e9
    h_frac_measured = (h_bytes / hdt) / (gather_gbps * 1e9)

    from basic_sparse_matrix_tpu import CSR
    from basic_sparse_matrix_tpu.ops import elementwise as ew

    import numpy as _np

    def _gen_csr(seed, n=N, inserts=INSERTS):
        r = _np.random.default_rng(seed)
        return CSR.from_coo_arrays(
            (n, n), r.integers(0, n, inserts), r.integers(0, n, inserts),
            (r.integers(0, 2**32, inserts) % 255 + 1).astype(_np.float32))

    sa, sb = _gen_csr(1000), _gen_csr(2000)
    plan = ew._MergePlan(sa, sb)
    chunked = ew._ChunkedMergePlan(plan, sa.stored, sb.stored)

    # Shipping path (config merge_numeric=chunked): issue-coalesced row
    # gathers + one-hot select.
    def add_step(operand, carry):
        va, vb = operand[0].values, carry
        return ew._merge_chunked_vals(
            va, vb, (chunked.c_a, chunked.l_a, chunked.c_b, chunked.l_b),
            plan.n, 1, chunked.w
        )[: sb.stored]

    adt = measure_loop(make_loop(add_step), (sa,), sb.values,
                       i1=20, i2=220, reps=2)
    _tick("ss_add_chunked")

    def add_planned_step(operand, carry):
        va, vb = operand[0].values, carry
        return ew._merge_planned_vals(
            va, vb, (plan.gather_a, plan.gather_b), plan.n, 1
        )[: sb.stored]

    apdt = measure_loop(make_loop(add_planned_step), (sa,), sb.values,
                        i1=5, i2=45, reps=2)
    _tick("ss_add_planned")

    # ---- ss_mul (SpGEMM) sub-metrics -------------------------------------
    # Reference workload: /root/reference/benches/sparse_sparse_mul.rs:6-37
    # — 1000x1000 sparse x sparse, nnz sweep 50..500k, throughput counted
    # in inserted elements. Top sweep point (500k inserts each, ~39% dense
    # after dedup): the shipping dispatch is masked-dense (ops/spgemm.spgemm
    # routes through spmm against the densified RHS); the timed step is
    # that numeric core, with B densified outside the loop like reference
    # construction.
    SS_MUL_INSERTS = 500_000
    ga, gb_csr = _gen_csr(3000, inserts=SS_MUL_INSERTS), _gen_csr(
        4000, inserts=SS_MUL_INSERTS)
    from basic_sparse_matrix_tpu.ops.spmm import spmm as _spmm

    gb_dense = jax.block_until_ready(gb_csr.todense())

    def ss_mul_dense_step(operand, carry):
        return _spmm(operand[0], carry)

    mdt = measure_loop(make_loop(ss_mul_dense_step), (ga,), gb_dense,
                       i1=20, i2=220, reps=2)
    _tick("ss_mul_dense")

    # True-sparse planned Gustavson at a scale where densifying B is the
    # wrong choice (n=100k): numeric phase = gather-multiply-scatter on the
    # memoised exact-pattern plan (ops/spgemm.spgemm_planned).
    import importlib

    _sg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")

    PN, PNNZ = 100_000, 500_000
    pa, pb = _gen_csr(5000, n=PN, inserts=PNNZ), _gen_csr(
        6000, n=PN, inserts=PNNZ)
    pplan = _sg._SpgemmPlan(pa, pb)

    def ss_mul_planned_step(operand, carry):
        va = operand[0].values
        out = _sg._spgemm_planned_vals(
            va, carry, (pplan.dst, pplan.src_a, pplan.src_b), pplan.nnz_c)
        return out[: pb.stored]

    pdt = measure_loop(make_loop(ss_mul_planned_step), (pa,), pb.values,
                       i1=5, i2=45, reps=2)
    _tick("ss_mul_planned")

    # Long-row regime: B has 32 entries per row, E ~ 2.5M — a scaled-down
    # replica of the 100k^2/E=12.8M workload where the SpGEMM numeric
    # frontier lives (planned vs rowgather). Plans build on host outside
    # the loop.
    _lr_rng = np.random.default_rng(7000)
    _lr_n = 40_000
    _lr_a = CSR.from_coo_arrays(
        (_lr_n, _lr_n), _lr_rng.integers(0, _lr_n, 80_000),
        _lr_rng.integers(0, _lr_n, 80_000),
        (_lr_rng.integers(0, 2**32, 80_000) % 255 + 1).astype(np.float32))
    _lr_b = CSR.from_coo_arrays(
        (_lr_n, _lr_n), np.repeat(np.arange(_lr_n), 32),
        _lr_rng.integers(0, _lr_n, 32 * _lr_n),
        (_lr_rng.integers(0, 2**32, 32 * _lr_n) % 255 + 1).astype(
            np.float32))
    _lr_plan = _sg._SpgemmPlan(_lr_a, _lr_b)

    def lr_planned_step(operand, carry):
        out = _sg._spgemm_planned_vals(
            operand[0].values, carry,
            (_lr_plan.dst, _lr_plan.src_a, _lr_plan.src_b),
            _lr_plan.nnz_c)
        return out[: _lr_b.stored]

    lrdt = measure_loop(make_loop(lr_planned_step), (_lr_a,),
                        _lr_b.values, i1=1, i2=5, reps=2)
    _tick("ss_mul_longrow_planned")
    _lr_rg = _lr_plan.rowg
    rgdt = None
    if _lr_rg is not None:
        _rg_maps = (_lr_rg["xa"], _lr_rg["ell_map"], _lr_rg["perm"],
                    _lr_plan.dst)

        def lr_rowgather_step(operand, carry):
            out = _sg._spgemm_rowgather_vals(
                operand[0].values, carry, _rg_maps, _lr_plan.nnz_c,
                _lr_rg["wB"], _lr_rg["uniform"])
            return out[: _lr_b.stored]

        rgdt = measure_loop(make_loop(lr_rowgather_step), (_lr_a,),
                            _lr_b.values, i1=1, i2=5, reps=2)
        _tick("ss_mul_rowgather")

    # ---- direct-solve sub-metrics: banded scan + BCR at the n=4096 shape -
    # The RCM-ordered 64x64 2D Laplacian is block-tridiagonal at nb=64,
    # m=64. SPD blocks of that exact shape are generated ON DEVICE (values
    # don't change the timing, shapes do). E is carried at length m with a
    # zero last coupling — the BCR convention; the scan backend takes
    # E[:-1].
    from basic_sparse_matrix_tpu.models import banded as _banded
    from basic_sparse_matrix_tpu.models import bcr as _bcr

    gm = nb4 = 64

    @jax.jit
    def make_blocks(key):
        kd, ke = jax.random.split(key)
        d = jax.random.normal(kd, (gm, nb4, nb4), jnp.float32) * 0.3
        d = d + jnp.swapaxes(d, 1, 2) + 4.0 * nb4 * jnp.eye(nb4)
        e = jax.random.normal(ke, (gm, nb4, nb4), jnp.float32) * 0.3
        return d, e.at[-1].set(0.0)

    D4, E4full = jax.block_until_ready(make_blocks(jax.random.PRNGKey(3)))
    E4 = E4full[:-1]
    prec = matmul_precision()

    def factor_step(e, d):
        L, _ = _banded.cholesky_banded_blocks(d, e)
        return jnp.matmul(L, jnp.swapaxes(L, 1, 2), precision=prec)

    fdt = measure_loop(make_loop(factor_step), E4, D4, i1=5, i2=55, reps=2)
    _tick("banded_factor")

    L4, F4 = _banded.cholesky_banded_blocks(D4, E4)
    b4 = jax.random.normal(jax.random.PRNGKey(2),
                           (gm, nb4, 8), jnp.float32)

    def solve_step(lf, carry):
        return _banded.solve_banded_blocks(lf[0], lf[1], carry)

    sdt = measure_loop(make_loop(solve_step), (L4, F4), b4,
                       i1=20, i2=220, reps=2)
    _tick("banded_solve")

    # BCR (block cyclic reduction) — the shipping banded backend
    # (config banded_solver=bcr): O(log m) batched stages, timed on the
    # refined shipping path (needs the full-length E).
    bcr_fac = _bcr.factor_bcr(D4, E4full)

    def bcr_solve_step(operand, carry):
        f, d, e = operand
        return _bcr._solve_refined(f, d, e, carry)  # shipping path (1 IR)

    bsdt = measure_loop(make_loop(bcr_solve_step), (bcr_fac, D4, E4full),
                        b4, i1=20, i2=220, reps=2)

    def bcr_total_step(de, carry):
        d, e = de
        return _bcr._solve_refined(_bcr.factor_bcr(d, e), d, e, carry)

    btdt = measure_loop(make_loop(bcr_total_step), (D4, E4full), b4,
                        i1=5, i2=55, reps=2)
    _tick("bcr")

    # ---- general-tier Cholesky sub-metric --------------------------------
    # Supernodal numeric phase on the 14^3 7-point Laplacian (n=2744) under
    # nested dissection — the general-tier path for 3D patterns whose
    # bandwidth exceeds the banded tier (reference capability:
    # the reference crate's src/sparse.rs:682-714). The timed step is the
    # full factorization with the values as the carry.
    from basic_sparse_matrix_tpu.models import supernodal as _sn
    from basic_sparse_matrix_tpu.ops.generators import laplacian_3d
    from basic_sparse_matrix_tpu.ops.reorder import (
        nd_permutation as _ndp,
        permute_symmetric as _psym,
    )

    _sn_a = laplacian_3d(14)
    _sn_a = _psym(_sn_a, _ndp(_sn_a))
    _ta = time.time()
    _sn_sched = _sn.analyze_supernodal(_sn_a, relax=32)
    sn_analyze_s = time.time() - _ta
    _sn_nnz = _sn_a.stored

    def sn_step(operand, carry):
        return _sn.factorize_supernodal(operand, carry)[:_sn_nnz]

    sndt = measure_loop(make_loop(sn_step), _sn_sched, _sn_a.values,
                        i1=2, i2=10, reps=2)
    _tick("supernodal")

    print(json.dumps({
        "metric": "spmm_sd_mul_elements_per_s",
        "value": float(f"{elements_per_s:.4g}"),
        "unit": "elements/s",
        "vs_baseline": float(f"{vs:.4g}"),
        "sparse": {
            "hypersparse_roofline_fraction": float(f"{h_frac:.4g}"),
            "hypersparse_vs_measured_gather": float(
                f"{h_frac_measured:.4g}"),
            "gather_random_GBps": float(f"{gather_gbps:.4g}"),
            "hypersparse_nnz_per_s": float(f"{hnnz / hdt:.4g}"),
            "ss_add_elements_per_s": float(
                f"{(sa.stored + sb.stored) / adt:.4g}"),
            "ss_add_s": float(f"{adt:.4g}"),
            "ss_add_planned_s": float(f"{apdt:.4g}"),
            "ss_mul_dense_elements_per_s": float(
                f"{SS_MUL_INSERTS / mdt:.4g}"),
            "ss_mul_dense_s": float(f"{mdt:.4g}"),
            "ss_mul_planned_elements_per_s": float(
                f"{PNNZ / pdt:.4g}"),
            "ss_mul_planned_s": float(f"{pdt:.4g}"),
            "ss_mul_longrow_planned_s": float(f"{lrdt:.4g}"),
            "ss_mul_rowgather_s": (
                float(f"{rgdt:.4g}") if rgdt is not None else None),
        },
        "solve": {
            "banded_factor_4096_ms": float(f"{fdt * 1e3:.4g}"),
            "banded_solve_4096_ms": float(f"{sdt * 1e3:.4g}"),
            "bcr_factor_4096_ms": float(f"{(btdt - bsdt) * 1e3:.4g}"),
            "bcr_solve_4096_ms": float(f"{bsdt * 1e3:.4g}"),
            "supernodal_numeric_ms": float(f"{sndt * 1e3:.4g}"),
            "supernodal_analyze_s": float(f"{sn_analyze_s:.4g}"),
        },
    }))


if __name__ == "__main__":
    main()
