"""Distributed serving: shard an SPD operator over the device mesh once,
then serve repeated solves/spectral queries from resident shards.

Run from the repository root on the GPUs of one host
(``PYTHONPATH=. python examples/distributed_serving.py``), or on a simulated
8-device CPU mesh:

    PYTHONPATH=. JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/distributed_serving.py
"""

import numpy as np

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.parallel.mesh import row_mesh
from basic_sparse_matrix_tpu.parallel.operator import DistributedOperator


def lap2d(k):
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


def main():
    import jax

    from basic_sparse_matrix_tpu.runtime.cache import enable_compile_cache

    enable_compile_cache()

    mesh = row_mesh(len(jax.devices()))
    a = lap2d(24)
    n = a.shape[0]
    op = DistributedOperator(CSR.from_dense(a), mesh)  # shard once

    rng = np.random.default_rng(0)
    for req in range(3):  # serve: repeated RHS against resident shards
        b = rng.standard_normal(n).astype(np.float32)
        x = np.asarray(op.solve_pcg(b, iters=60))
        res = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
        print(f"request {req}: rel residual {res:.2e}")
    ritz = np.asarray(op.eigen_values(k=16))
    print(f"spectral bounds ~[{ritz[0]:.3f}, {ritz[-1]:.3f}], "
          f"cond ~{ritz[-1]/ritz[0]:.1f}")


if __name__ == "__main__":
    main()
