"""Times the alternatives behind each kernel and dispatch decision of the
GPU bring-up, both ends in one process on one card.

Sections (``--only`` picks some):

* ``spmm_ladder``: SpMM at 1000² x 128 RHS over a density sweep, dense
  matmul (the memoised densified operand, HIGHEST precision) vs ELL
  gather+FMA (``spmm_ell``, the Triton kernel on the GPU) vs
  gather/segment-sum; sets ``dense_dispatch_density``.
* ``ell``: the XLA ELL path (``ops.ell.spmm_ell_xla``) vs the
  Pallas-Triton ELL kernel (``ops.ell_triton``) over block shapes, at 100k
  and 1M rows x 32/row x 512 RHS.
* ``supernodal``: the supernodal numeric phase of the ND-ordered k³
  Laplacian under each forced read/scatter mode and under the per-level
  rule (``auto``), for k=14 and k=33.

Each case prints one JSON line (median of ``--reps`` calls fenced with
``block_until_ready``, after one warm-up call that compiles) naming the
device; lines are also appended to ``chiprun_out/kernel_decisions.jsonl``.
Raises without a GPU.

Usage: python benchmarks/kernel_decisions.py [--only spmm_ladder,ell]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "kernel_decisions.jsonl")


def _time(fn, reps):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), compile_s


def _emit(rec):
    import jax

    d = jax.devices()[0]
    rec = {"platform": d.platform, "device_kind": d.device_kind, **rec}
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def spmm_ladder(reps):
    import jax
    import jax.numpy as jnp

    from basic_sparse_matrix_tpu import CSR
    from basic_sparse_matrix_tpu.ops import ell as E
    from basic_sparse_matrix_tpu.ops.spmm import spmm
    from basic_sparse_matrix_tpu.utils.config import matmul_precision

    n, n_rhs = 1000, 128
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((n, n_rhs)).astype(np.float32))
    dense_mm = jax.jit(lambda d, x: jnp.dot(d, x,
                                            precision=matmul_precision()))
    for dens in (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1):
        nnz = int(dens * n * n)
        a = CSR.from_coo_arrays((n, n), rng.integers(0, n, nnz),
                                rng.integers(0, n, nnz),
                                rng.standard_normal(nnz).astype(np.float32))
        ad = a.todense()
        ell = E.csr_to_ell(a)
        for name, fn in (("dense", lambda: dense_mm(ad, b)),
                         ("ell", lambda: E.spmm_ell(ell, b)),
                         ("gather_segment", lambda: spmm(a, b))):
            med, best, comp = _time(fn, reps)
            _emit({"section": "spmm_ladder", "density": a.get_density(),
                   "path": name, "median_s": med, "min_s": best})


def ell_kernels(reps):
    import jax
    import jax.numpy as jnp

    from basic_sparse_matrix_tpu.ops.ell import ELL, spmm_ell_xla
    from basic_sparse_matrix_tpu.ops.ell_triton import spmm_ell_triton

    per_row, n_rhs = 32, 512
    configs = [(16, 128, 4), (32, 128, 4), (64, 128, 4), (32, 256, 8),
               (16, 512, 8)]
    results = []
    for rows in (100_000, 1 << 20):
        key = jax.random.key(rows)
        kc, kv, kb = jax.random.split(key, 3)
        ell = ELL(cols=jax.random.randint(kc, (rows, per_row), 0, rows,
                                          jnp.int32),
                  vals=jax.random.normal(kv, (rows, per_row), jnp.float32),
                  n_cols=rows)
        b = jax.random.normal(kb, (rows, n_rhs), jnp.float32)
        ref = jax.block_until_ready(spmm_ell_xla(ell, b))
        bytes_ = rows * per_row * (8 + n_rhs * 4) + rows * n_rhs * 4
        med, best, comp = _time(lambda: spmm_ell_xla(ell, b), reps)
        _emit({"section": "ell", "rows": rows, "path": "xla_spmm_ell",
               "median_s": med, "min_s": best, "compile_s": comp,
               "bytes": bytes_, "GBps": bytes_ / med / 1e9})
        cfgs = configs if rows == 100_000 else [best_cfg] if results else []
        results = []
        for br, bc, nw in cfgs:
            fn = lambda: spmm_ell_triton(ell, b, block_rows=br,  # noqa
                                         block_cols=bc, num_warps=nw)
            try:
                out = jax.block_until_ready(fn())
            except Exception as e:  # a refused kernel is a finding
                _emit({"section": "ell", "rows": rows, "path": "triton",
                       "block_rows": br, "block_cols": bc, "num_warps": nw,
                       "error": f"{type(e).__name__}: {str(e)[:600]}"})
                continue
            err = float(jnp.abs(out - ref).max() / jnp.abs(ref).max())
            med, best, comp = _time(fn, reps)
            results.append((med, (br, bc, nw)))
            _emit({"section": "ell", "rows": rows, "path": "triton",
                   "block_rows": br, "block_cols": bc, "num_warps": nw,
                   "rel_err_vs_xla": err, "median_s": med, "min_s": best,
                   "compile_s": comp, "GBps": bytes_ / med / 1e9})
        if rows == 100_000 and results:
            best_cfg = min(results)[1]
        del ell, b, ref


def supernodal_modes(reps, ks):
    import jax

    from basic_sparse_matrix_tpu.models import supernodal as sn
    from basic_sparse_matrix_tpu.ops.generators import laplacian_3d
    from basic_sparse_matrix_tpu.ops.reorder import (
        nd_permutation,
        permute_symmetric,
    )
    from basic_sparse_matrix_tpu.utils import config as C

    base = C.get_config()
    modes = [("auto", "auto"), ("element", "element"),
             ("window", "element"), ("element", "delta"),
             ("window", "delta")]
    for k in ks:
        a = laplacian_3d(k)
        a = permute_symmetric(a, nd_permutation(a))
        t0 = time.perf_counter()
        sched = sn.analyze_supernodal(a, relax=base.supernodal_relax)
        analyze_s = time.perf_counter() - t0
        n_g = sched.n_groups
        auto_window = sum(sched.use_window)
        auto_delta = sum(sched.use_delta)
        ref = None
        for gather, scatter in modes:
            C.set_config(dataclasses.replace(
                base, supernodal_gather=gather, supernodal_scatter=scatter))
            try:
                fn = lambda: sn.factorize_supernodal(sched, a.values)  # noqa
                med, best, comp = _time(fn, reps)
                lv = np.asarray(fn())
            finally:
                C.set_config(base)
            if ref is None:
                ref = lv
            err = float(np.abs(lv - ref).max() / np.abs(ref).max())
            _emit({"section": "supernodal", "k": k, "n": a.rows,
                   "groups": n_g, "auto_window_groups": auto_window,
                   "auto_delta_groups": auto_delta, "analyze_s": analyze_s,
                   "gather": gather, "scatter": scatter,
                   "median_s": med, "min_s": best, "compile_s": comp,
                   "rel_diff_vs_auto": err})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="spmm_ladder,ell,supernodal")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ks", default="14,33")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError("kernel_decisions times the GPU; JAX's backend "
                           f"is {jax.default_backend()!r}")
    from basic_sparse_matrix_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()
    only = set(args.only.split(","))
    if "spmm_ladder" in only:
        spmm_ladder(args.reps)
    if "ell" in only:
        ell_kernels(args.reps)
    if "supernodal" in only:
        supernodal_modes(args.reps, [int(k) for k in args.ks.split(",")])


if __name__ == "__main__":
    main()
