"""Smoke run of the sparse library on one NVIDIA GPU (or four with --multi).

Drives the main paths once through the public API at deployment scale and
checks every result against a plain host reference built with numpy/scipy
from ``--seed`` data:

* A. hypersparse SpMM, 1M rows x 32 random columns per row x 512 RHS
  (``ops.spmm_auto``, which lands on the ELL gather+FMA path);
* B. sparse direct solve of the k=33 7-point 3D Laplacian (n=35,937) with
  1 and 8 right-hand sides (``prepare_direct``: nested dissection, the
  supernodal factorization, level-set triangular solves);
* C. the reference crate's three criterion workloads: ``sd_mul``
  (dense dispatch), ``ss_add`` (planned merge) and ``ss_mul`` (SpGEMM).

``--multi`` needs four GPUs in this one process and runs only the mesh
layer (``DistributedOperator`` over a 1D ``rows`` mesh): row-sharded SpMM
at 4M x 32/row x 512, block-Jacobi PCG on the k=48 3D Laplacian and
distributed SpGEMM of that Laplacian with itself.

It refuses to run without a GPU. The last line of standard output is one
JSON object naming the device; any failed check raises and exits non-zero.

Usage: python chip_smoke.py [--seed N] [--multi]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def require_gpu(count: int = 1):
    """The GPU devices to run on; raises anywhere else."""
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"chip_smoke needs an NVIDIA GPU; JAX's backend is "
            f"{jax.default_backend()!r}")
    devices = jax.devices()
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX sees {len(devices)}")
    return devices[:count]


def card_info() -> str:
    """Name and power limit of the cards, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def _check(name: str, ok: bool, detail: str):
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def hypersparse_csr(rows: int, per_row: int, seed: int):
    """rows x rows CSR with ``per_row`` uniformly random columns per row
    (sorted within the row; repeats are kept and sum), standard-normal
    values. Returns the CSR and its host (cols, vals) as (rows, per_row)."""
    import jax.numpy as jnp

    from basic_sparse_matrix_tpu import CSR

    rng = np.random.default_rng(seed)
    cols = np.sort(rng.integers(0, rows, (rows, per_row), dtype=np.int32),
                   axis=1)
    vals = rng.standard_normal((rows, per_row), dtype=np.float32)
    a = CSR(indptr=jnp.arange(0, rows * per_row + 1, per_row,
                              dtype=jnp.int32),
            indices=jnp.asarray(cols.reshape(-1)),
            values=jnp.asarray(vals.reshape(-1)), rows=rows, cols=rows)
    return a, cols, vals


def check_sampled_rows(name, c, b, cols, vals, n_check, seed):
    """Compare ``n_check`` sampled rows of C = A·B against float64 numpy:
    max abs error <= 1e-4 * max |ref| (a float32 gather+FMA, no matmul,
    so no TF32 is involved)."""
    import jax.numpy as jnp

    rows, per_row = cols.shape
    _check(name, c.shape[0] >= rows and c.shape[1] == b.shape[1],
           f"output shape {c.shape}")
    rng = np.random.default_rng(seed + 1)
    idx = np.sort(rng.choice(rows, size=min(n_check, rows), replace=False))
    bg = np.asarray(b[jnp.asarray(cols[idx].reshape(-1))], np.float64)
    ref = (vals[idx].astype(np.float64)[:, :, None]
           * bg.reshape(len(idx), per_row, -1)).sum(axis=1)
    got = np.asarray(c[jnp.asarray(idx)], np.float64)
    _check(name, bool(np.isfinite(got).all()), "non-finite output")
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    _check(name, err <= 1e-4, f"max abs err {err:.3e} x max|ref| > 1e-4")
    return {"rows_checked": int(len(idx)), "rel_max_err": err,
            "tolerance": "max|C-ref| <= 1e-4 max|ref|, float32 vs float64"}


def phase_a(seed: int, rows: int = 1 << 20, per_row: int = 32,
            n_rhs: int = 512, n_check: int = 4096) -> dict:
    """Hypersparse SpMM through the library's density dispatch (on the GPU
    the ELL rung runs the Pallas-Triton kernel), checked on sampled rows
    against float64 numpy and in full against the XLA formulation."""
    import jax
    import jax.numpy as jnp

    from basic_sparse_matrix_tpu.ops import spmm_auto
    from basic_sparse_matrix_tpu.ops.ell import csr_to_ell, spmm_ell_xla

    a, cols, vals = hypersparse_csr(rows, per_row, seed)
    b = jax.random.normal(jax.random.key(seed), (rows, n_rhs), jnp.float32)
    c, first = _timed(spmm_auto, a, b)
    _, again = _timed(spmm_auto, a, b)
    out = check_sampled_rows("phase A", c, b, cols, vals, n_check, seed)
    ref = spmm_ell_xla(csr_to_ell(a), b)
    vs_xla = float(jnp.abs(c - ref).max() / jnp.abs(ref).max())
    del ref
    _check("phase A", vs_xla <= 1e-5,
           f"max|C - XLA ELL| {vs_xla:.3e} x max|ref| > 1e-5")
    out.update(shape=[rows, per_row, n_rhs], first_call_s=first,
               second_call_s=again, rel_max_diff_vs_xla_ell=vs_xla)
    return out


def phase_b(seed: int, k: int = 33, n_rhs=(1, 8),
            kind: str = "supernodal") -> dict:
    """Sparse direct solve (ordering, supernodal factor, level-set solves)
    of the k³ 7-point Laplacian, checked by its residual and against
    scipy's float64 LU solve."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from basic_sparse_matrix_tpu import prepare_direct
    from basic_sparse_matrix_tpu.ops import spmm_auto
    from basic_sparse_matrix_tpu.ops.generators import laplacian_3d

    a = laplacian_3d(k)
    n = a.rows
    t0 = time.perf_counter()
    solver = prepare_direct(a)
    prepare_s = time.perf_counter() - t0
    _check("phase B", solver.kind == kind,
           f"solver kind {solver.kind!r}, want {kind!r}")
    indptr, indices, values = a.numpy()
    lu = spla.splu(sp.csr_matrix((values.astype(np.float64), indices,
                                  indptr), shape=(n, n)).tocsc())
    rng = np.random.default_rng(seed)
    out = {"n": n, "kind": solver.kind, "prepare_s": prepare_s,
           "tolerance": "||Ax-b||/||b|| <= 1e-4 (HIGHEST on device); "
                        "||x-x64||/||x64|| <= 1e-3 vs scipy splu "
                        "(float32 factor, cond ~5e2)"}
    for m in n_rhs:
        bh = rng.standard_normal((n, m)).astype(np.float32)
        b = jnp.asarray(bh)
        x, secs = _timed(solver.solve, b)
        with jax.default_matmul_precision("highest"):
            r = spmm_auto(a, x) - b
            res = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
        xr = lu.solve(bh.astype(np.float64))
        err = float(np.linalg.norm(np.asarray(x, np.float64) - xr)
                    / np.linalg.norm(xr))
        _check("phase B", res <= 1e-4, f"{m} RHS: residual {res:.3e}")
        _check("phase B", err <= 1e-3, f"{m} RHS: rel err {err:.3e}")
        out[f"rhs{m}"] = {"solve_s": secs, "rel_residual": res,
                          "rel_err_vs_scipy": err}
    return out


def reference_csr(n: int, inserts: int, seed: int, vmax: int = 4):
    """The reference crate's criterion generator (random (row, col)
    inserts, duplicates summed) with values drawn from 1..vmax, so that
    every product and sum of phase C is an integer below 2^24 and float32
    results compare exactly. Returns the CSR and its scipy twin."""
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu import CSR

    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, inserts)
    c = rng.integers(0, n, inserts)
    v = rng.integers(1, vmax + 1, inserts).astype(np.float32)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    ref = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))
    return a, ref


def _exact(name, got, ref):
    got = np.asarray(got, np.float64)
    bad = int(np.count_nonzero(got != ref))
    _check(name, got.shape == ref.shape and bad == 0,
           f"{bad} entries differ from scipy")


def phase_c(seed: int, n: int = 1000, sd_inserts: int = 900_000,
            add_inserts: int = 900_000, mul_inserts: int = 500_000,
            n_rhs: int = 128) -> dict:
    """sd_mul, ss_add and ss_mul, each compared exactly with scipy."""
    import jax.numpy as jnp

    from basic_sparse_matrix_tpu import spgemm
    from basic_sparse_matrix_tpu.ops import elementwise, spmm_auto

    out = {"tolerance": "exact (integer values < 2^24)"}
    a, a_ref = reference_csr(n, sd_inserts, seed)
    bh = np.random.default_rng(seed + 7).integers(
        0, 4, (n, n_rhs)).astype(np.float32)
    c, secs = _timed(spmm_auto, a, jnp.asarray(bh))
    _exact("sd_mul", c, a_ref @ bh.astype(np.float64))
    out["sd_mul"] = {"stored": a.stored, "s": secs}

    x, x_ref = reference_csr(n, add_inserts, seed + 1)
    y, y_ref = reference_csr(n, add_inserts, seed + 2)
    s, secs = _timed(elementwise.add, x, y)
    _exact("ss_add", s.todense(), (x_ref + y_ref).toarray())
    out["ss_add"] = {"stored": [x.stored, y.stored], "s": secs}

    p, p_ref = reference_csr(n, mul_inserts, seed + 3)
    q, q_ref = reference_csr(n, mul_inserts, seed + 4)
    m, secs = _timed(spgemm, p, q)
    _exact("ss_mul", m.todense(), (p_ref @ q_ref).toarray())
    out["ss_mul"] = {"stored": [p.stored, q.stored], "s": secs}
    return out


def _devices_of(x) -> int:
    return len(x.sharding.device_set)


def multi_matmul(mesh, seed: int, rows: int = 1 << 22, per_row: int = 32,
                 n_rhs: int = 512, n_check: int = 4096) -> dict:
    """DistributedOperator.matmul on a hypersparse A, 1M rows per card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from basic_sparse_matrix_tpu.parallel.operator import DistributedOperator

    ndev = mesh.devices.size
    a, cols, vals = hypersparse_csr(rows, per_row, seed)
    t0 = time.perf_counter()
    op = DistributedOperator(a, mesh)
    shard_s = time.perf_counter() - t0
    b = jax.jit(lambda k: jax.random.normal(k, (rows, n_rhs), jnp.float32),
                out_shardings=NamedSharding(mesh, P()))(jax.random.key(seed))
    c, first = _timed(op.matmul, b)
    _, again = _timed(op.matmul, b)
    _check("multi matmul", _devices_of(op.sa.values) == ndev
           and _devices_of(c) == ndev,
           f"A on {_devices_of(op.sa.values)}, C on {_devices_of(c)} "
           f"devices, want {ndev}")
    out = check_sampled_rows("multi matmul", c, b, cols, vals, n_check, seed)
    out.update(shape=[rows, per_row, n_rhs], devices=_devices_of(c),
               shard_s=shard_s, first_call_s=first, second_call_s=again)
    return out


def multi_pcg(mesh, seed: int, k: int = 48, iters: int = 400) -> dict:
    """Block-Jacobi PCG on the k³ Laplacian, one dense diagonal block per
    card, to a float64 relative residual <= 1e-5."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.ops.generators import laplacian_3d
    from basic_sparse_matrix_tpu.parallel.operator import DistributedOperator

    ndev = mesh.devices.size
    a = laplacian_3d(k)
    n = a.rows
    op = DistributedOperator(a, mesh)
    bh = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x, secs = _timed(op.solve_pcg, jnp.asarray(bh), iters)
    _check("multi pcg", _devices_of(x) == ndev,
           f"x on {_devices_of(x)} devices, want {ndev}")
    indptr, indices, values = a.numpy()
    a64 = sp.csr_matrix((values.astype(np.float64), indices, indptr),
                        shape=(n, n))
    res = float(np.linalg.norm(a64 @ np.asarray(x, np.float64) - bh)
                / np.linalg.norm(bh))
    _check("multi pcg", res <= 1e-5, f"residual {res:.3e} > 1e-5")
    return {"n": n, "block_rows": -(-n // ndev), "iters": iters,
            "rel_residual": res, "devices": _devices_of(x), "s": secs,
            "tolerance": "||Ax-b||/||b|| <= 1e-5 in float64 on the host"}


def multi_spgemm(mesh, k: int = 48) -> dict:
    """Distributed SpGEMM A·A of the k³ Laplacian, compared exactly."""
    import scipy.sparse as sp

    from basic_sparse_matrix_tpu.ops.generators import laplacian_3d
    from basic_sparse_matrix_tpu.parallel.operator import DistributedOperator

    a = laplacian_3d(k)
    n = a.rows
    op = DistributedOperator(a, mesh)
    c, secs = _timed(op.matmul_sparse, a)
    indptr, indices, values = a.numpy()
    a64 = sp.csr_matrix((values.astype(np.float64), indices, indptr),
                        shape=(n, n))
    ref = (a64 @ a64).tocsr()
    ci, cx, cv = c.numpy()
    got = sp.csr_matrix((cv.astype(np.float64), cx, ci), shape=(n, n))
    bad = int((got != ref).nnz)
    _check("multi spgemm", bad == 0, f"{bad} entries differ from scipy")
    return {"n": n, "nnz_c": int(ref.nnz), "s": secs,
            "devices": _devices_of(op.sa.values),
            "tolerance": "exact (integer values)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: the mesh-layer phases only")
    args = ap.parse_args(argv)

    devices = require_gpu(4 if args.multi else 1)
    import jax

    from basic_sparse_matrix_tpu.runtime import symbolic
    from basic_sparse_matrix_tpu.runtime.cache import enable_compile_cache

    cache = enable_compile_cache()
    print(f"devices: {devices}", flush=True)
    print(f"card (name, power limit): {card_info()}", flush=True)
    print(f"native symbolic library loaded: "
          f"{symbolic.native_lib() is not None}", flush=True)
    print(f"compile cache: {cache}", flush=True)

    if args.multi:
        from basic_sparse_matrix_tpu.parallel.mesh import make_mesh

        mesh = make_mesh((4,), ("rows",), devices)
        phases = [("multi_matmul", lambda: multi_matmul(mesh, args.seed)),
                  ("multi_pcg", lambda: multi_pcg(mesh, args.seed)),
                  ("multi_spgemm", lambda: multi_spgemm(mesh))]
    else:
        phases = [("A", lambda: phase_a(args.seed)),
                  ("B", lambda: phase_b(args.seed)),
                  ("C", lambda: phase_c(args.seed))]
    for name, run in phases:
        t0 = time.perf_counter()
        result = run()
        result["wall_s"] = time.perf_counter() - t0
        print(f"phase {name}: {json.dumps(result)}", flush=True)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
