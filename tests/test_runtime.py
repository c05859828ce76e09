"""Runtime subsystem tests: native symbolic library, checkpoint/resume,
profiling metrics, config, logging."""

import io
import logging
import os

import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.runtime import symbolic
from basic_sparse_matrix_tpu.runtime.checkpoint import (
    checkpointed_factorize,
    load_csr,
    load_factor_state,
    save_csr,
    save_factor_state,
)
from basic_sparse_matrix_tpu.runtime.profiling import (
    OpMetrics,
    peak_spec,
    spmm_cost,
    timed,
)
from basic_sparse_matrix_tpu.utils.config import Config

H100 = "NVIDIA H100 80GB HBM3"
from basic_sparse_matrix_tpu.utils.logging import configure, event


class TestNativeSymbolic:
    def test_native_lib_builds(self):
        assert symbolic.native_lib() is not None, (
            "g++ available in this image; native build must succeed"
        )

    def test_native_matches_fallback(self):
        # same answers from C++ and numpy paths
        rng = np.random.default_rng(0)
        n = 40
        m = (rng.random((n, n)) < 0.1)
        m = np.tril(m | m.T, -1)
        rows, cols = np.nonzero(m)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr[1:], rows, 1)
        indptr = np.cumsum(indptr)

        lib = symbolic._lib
        try:
            parent_native = symbolic.etree(n, indptr, cols)
            _, lp_n, li_n = symbolic.chol_symbolic(n, indptr, cols)
            lev_n, nl_n = symbolic.level_sets(n, lp_n, li_n)
            symbolic._lib = False  # force fallback
            parent_py = symbolic.etree(n, indptr, cols)
            _, lp_p, li_p = symbolic.chol_symbolic(n, indptr, cols)
            lev_p, nl_p = symbolic.level_sets(n, lp_p, li_p)
        finally:
            symbolic._lib = lib
        assert np.array_equal(parent_native, parent_py)
        assert np.array_equal(lp_n, lp_p)
        assert np.array_equal(li_n, li_p)
        assert np.array_equal(lev_n, lev_p) and nl_n == nl_p

    def test_coo_perm(self):
        indptr, perm = symbolic.coo_to_csr_perm(
            3, [2, 0, 2, 1], [1, 0, 0, 2])
        assert indptr.tolist() == [0, 1, 2, 4]
        # applying perm must yield row-major (row, col) order
        rows = np.asarray([2, 0, 2, 1])[perm]
        cols = np.asarray([1, 0, 0, 2])[perm]
        keys = rows * 3 + cols
        assert (np.diff(keys) > 0).all()


class TestCheckpoint:
    def test_csr_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        d = (rng.random((20, 30)) < 0.2) * rng.standard_normal((20, 30))
        a = CSR.from_dense(d.astype(np.float32))
        p = str(tmp_path / "m.npz")
        save_csr(p, a)
        b = load_csr(p)
        assert b.shape == a.shape and b.allclose(a)

    def test_factor_state_roundtrip(self, tmp_path):
        p = str(tmp_path / "f.npz")
        save_factor_state(p, np.arange(5, dtype=np.float32), 3)
        lv, done = load_factor_state(p)
        assert done == 3 and lv.tolist() == [0, 1, 2, 3, 4]

    def test_checkpointed_factorize_matches(self, tmp_path):
        from basic_sparse_matrix_tpu.models.sparse_cholesky import (
            analyze,
            factorize,
        )

        n = 24
        a_dense = (4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
                   ).astype(np.float32)
        a = CSR.from_dense(a_dense)
        sched = analyze(a)
        direct = np.asarray(factorize(sched, a.values))
        p = str(tmp_path / "ck.npz")
        chunked = checkpointed_factorize(sched, np.asarray(a.values), p,
                                         every=5)
        assert np.allclose(direct, chunked, rtol=1e-6)
        # a checkpoint file must have been written mid-run (nlev=24 > 5)
        assert os.path.exists(p)
        # resume from the checkpoint: must still produce the same factor
        resumed = checkpointed_factorize(sched, np.asarray(a.values), p,
                                         every=5)
        assert np.allclose(direct, resumed, rtol=1e-6)


class TestProfiling:
    def test_timed_records(self):
        with timed("unit_op", flops=100.0, bytes_moved=50.0, nnz=10) as m:
            pass
        assert m.seconds >= 0
        assert m.nnz_per_s >= 0
        assert 0 <= m.roofline_fraction(peak_spec(H100)) < 1e12

    def test_chip_detect(self):
        # no peak table entry for the CPU: a roofline there is an error
        with pytest.raises(KeyError, match="device_kind"):
            peak_spec()

    def test_spmm_cost(self):
        c = spmm_cost(nnz=1000, n_rhs=64, rows=100, cols=100)
        assert c["flops"] == 2 * 1000 * 64
        assert c["bytes_moved"] > 0

    def test_metrics_json(self):
        m = OpMetrics(op="x", seconds=0.5, flops=1e9, bytes_moved=1e6,
                      nnz=500)
        js = m.to_json()
        assert '"op": "x"' in js and "gflops_per_s" in js


class TestConfigLogging:
    def test_config_env_override(self, monkeypatch):
        monkeypatch.setenv("BSM_DENSE_DISPATCH_DENSITY", "0.5")
        cfg = Config.from_env()
        assert cfg.dense_dispatch_density == 0.5

    def test_config_defaults(self):
        cfg = Config()
        assert cfg.matmul_precision == "highest"
        assert cfg.supernodal_gather == "auto"
        assert cfg.supernodal_scatter == "auto"

    def test_json_logging(self):
        buf = io.StringIO()
        configure(level=logging.INFO, json_lines=True, stream=buf)
        event("solve_done", n=42, seconds=0.1)
        out = buf.getvalue()
        assert '"event": "solve_done"' in out and '"n": 42' in out
