"""Weak-scaling study: row-sharded SpMM across 1/2/4/8 devices with
problem size proportional to device count.

Runs on the backend JAX finds and raises when it has fewer than 2 devices.
On the CPU, simulate a mesh with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=8. Emits one JSON line per
device count (each naming the platform and device kind) plus an efficiency
summary.

Usage: python benchmarks/weak_scaling.py [--rows-per-dev 65536]
       [--nnz-per-row 16] [--n-rhs 8]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-dev", type=int, default=65536)
    ap.add_argument("--nnz-per-row", type=int, default=16)
    ap.add_argument("--n-rhs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import jax

    from basic_sparse_matrix_tpu.ops.csr import CSR
    from basic_sparse_matrix_tpu.parallel.mesh import row_mesh
    from basic_sparse_matrix_tpu.parallel.sharded import put_sharded, shard_csr
    from basic_sparse_matrix_tpu.parallel.spmm import spmm_sharded

    avail = len(jax.devices())
    if avail < 2:
        raise RuntimeError(
            f"weak scaling needs >= 2 devices; the {jax.default_backend()} "
            f"backend has {avail}")
    dev = jax.devices()[0]
    counts = [c for c in (1, 2, 4, 8) if c <= avail]
    results = {}
    rng = np.random.default_rng(0)
    for num in counts:
        rows = args.rows_per_dev * num
        nnz = rows * args.nnz_per_row
        a = CSR.from_coo_arrays(
            (rows, rows),
            np.repeat(np.arange(rows), args.nnz_per_row),
            rng.integers(0, rows, nnz),
            rng.standard_normal(nnz).astype(np.float32),
            sum_duplicates=False,
        )
        b = jax.numpy.asarray(rng.standard_normal((rows, args.n_rhs))
                        .astype(np.float32))
        mesh = row_mesh(num)
        sa = put_sharded(shard_csr(a, num), mesh)
        jax.block_until_ready(spmm_sharded(sa, b, mesh))  # compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            y = spmm_sharded(sa, b, mesh)
        jax.block_until_ready(y)
        dt = (time.perf_counter() - t0) / args.iters
        results[num] = dt
        print(json.dumps({
            "group": "weak_scaling_spmm", "platform": dev.platform,
            "device_kind": dev.device_kind, "devices": num, "rows": rows,
            "nnz": nnz, "seconds_per_iter": dt,
            "nnz_per_s": float(f"{nnz / dt:.4g}"),
        }), flush=True)

    base = results[counts[0]]
    for num in counts[1:]:
        eff = base / results[num]
        print(json.dumps({
            "group": "weak_scaling_efficiency", "devices": num,
            "efficiency": float(f"{eff:.4g}"),
        }), flush=True)


if __name__ == "__main__":
    main()
