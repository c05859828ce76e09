"""End-to-end example: solve a 2D Poisson problem three ways.

Demonstrates the user-facing surface a reference-crate user lands on:
construct a sparse SPD operator, then solve with (1) the dense-path direct
solver (reference ``solve`` parity), (2) the fully sparse level-scheduled
pipeline, (3) IC(0)-preconditioned CG — and, when multiple devices are
present, (4) distributed CG over a row-sharded operator.

Run: ``python examples/poisson_solve.py [--k 32]``
"""

from __future__ import annotations

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def poisson_2d(k: int):
    n = k * k
    idx = np.arange(n)
    i, j = idx // k, idx % k
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0, np.float32)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < k) & (jj >= 0) & (jj < k)
        rows.append(idx[ok])
        cols.append((ii * k + jj)[ok])
        vals.append(np.full(int(ok.sum()), -1.0, np.float32))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from basic_sparse_matrix_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    from basic_sparse_matrix_tpu import CSR, solve
    from basic_sparse_matrix_tpu.models.pcg import pcg_solve
    from basic_sparse_matrix_tpu.models.solve import solve_sparse

    rows, cols, vals, n = poisson_2d(args.k)
    a = CSR.from_coo_arrays((n, n), rows, cols, vals, sum_duplicates=False)
    print(f"operator: {a!r}")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n).astype(np.float32)

    def report(name, x):
        x = np.asarray(x).ravel()[:n]
        res = np.linalg.norm(
            np.asarray(a.todense()) @ x - b) / np.linalg.norm(b)
        print(f"{name:>18}: relative residual {res:.2e}")

    report("dense direct", solve(a, b))
    report("sparse direct", solve_sparse(a, b))
    x, iters, rres = pcg_solve(a, b, tol=1e-8, max_iters=1000)
    print(f"{'IC(0)-PCG':>18}: {iters} iterations")
    report("IC(0)-PCG", x)

    if len(jax.devices()) >= 2:
        from basic_sparse_matrix_tpu.parallel.cg import cg_solve_sharded
        from basic_sparse_matrix_tpu.parallel.mesh import row_mesh
        from basic_sparse_matrix_tpu.parallel.sharded import (
            put_sharded,
            shard_csr,
        )

        num = len(jax.devices())
        mesh = row_mesh(num)
        sa = put_sharded(shard_csr(a, num), mesh)
        x = cg_solve_sharded(sa, jnp.asarray(b), mesh, iters=400)
        report(f"distributed CG x{num}", x)


if __name__ == "__main__":
    main()
