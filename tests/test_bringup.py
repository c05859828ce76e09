"""What the GPU bring-up left: one peak table, the compile-cache helper,
the SpMM density ladder, the supernodal mode routing and its config checks,
the content-hashed native build, and the precision context for dense
factorizations."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from basic_sparse_matrix_tpu import CSR
from basic_sparse_matrix_tpu.runtime import cache, profiling, symbolic
from basic_sparse_matrix_tpu.utils import config as C
from basic_sparse_matrix_tpu.utils.errors import ConfigError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- peak table -----------------------------------------------------------
def test_h100_peaks_from_data_sheet():
    spec = profiling.peak_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_bw == 3.35e12
    assert spec.tf32 == 4.95e14
    assert spec.f32 == 6.7e13
    assert "data sheet" in spec.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H200"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        profiling.peak_spec(kind)


def test_roofline_uses_the_table():
    spec = profiling.peak_spec("NVIDIA H100 80GB HBM3")
    m = profiling.OpMetrics(op="x", seconds=1.0, bytes_moved=3.35e12)
    assert m.roofline_fraction(spec) == pytest.approx(1.0)


# ---- compile cache --------------------------------------------------------
def test_cache_env_var_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = cache.compile_cache_dir()
    assert first == os.path.join(ROOT, ".jax_cache")
    assert cache.compile_cache_dir() == first       # no pid, no time
    assert str(os.getpid()) not in first


def test_library_import_sets_no_cache():
    assert jax.config.jax_compilation_cache_dir in (
        None, os.environ.get("JAX_COMPILATION_CACHE_DIR"))


# ---- SpMM density ladder --------------------------------------------------
def _random_csr(n, density, seed=0):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, n)) < density)
         * rng.standard_normal((n, n))).astype(np.float32)
    return CSR.from_dense(d), d


def _uniform_rows_csr(n=1000, per_row=2):
    # density 0.002, every row the same length: ELL overhead 1
    d = np.zeros((n, n), np.float32)
    rng = np.random.default_rng(2)
    for r in range(n):
        d[r, rng.choice(n, per_row, replace=False)] = rng.standard_normal(
            per_row)
    return CSR.from_dense(d), d


def _skewed_csr(n=1000):
    # one dense row: ELL padding overhead far above the cap
    d = np.zeros((n, n), np.float32)
    d[0, :] = 1.0
    d[np.arange(1, n), np.arange(1, n)] = 2.0
    return CSR.from_dense(d), d


@pytest.mark.parametrize("case,path", [
    ("dense", "dense"), ("hyper", "ell"), ("skewed", "gather")])
def test_spmm_dispatch_by_density(case, path, monkeypatch):
    import importlib

    E = importlib.import_module("basic_sparse_matrix_tpu.ops.ell")
    S = importlib.import_module("basic_sparse_matrix_tpu.ops.spmm")
    if case == "dense":
        a, d = _random_csr(120, 0.3)
    elif case == "hyper":
        a, d = _uniform_rows_csr()
    else:
        a, d = _skewed_csr()
    taken = []
    real_ell, real_gather = E.spmm_ell_from_csr, S.spmm
    monkeypatch.setattr(E, "spmm_ell_from_csr",
                        lambda *x: taken.append("ell") or real_ell(*x))
    monkeypatch.setattr(S, "spmm",
                        lambda *x: taken.append("gather") or real_gather(*x))
    b = np.random.default_rng(1).standard_normal(
        (a.cols, 8)).astype(np.float32)
    out = np.asarray(S.spmm_auto(a, jnp.asarray(b)))
    assert taken == ([] if path == "dense" else [path])
    assert np.allclose(out, d @ b, rtol=1e-4, atol=1e-4)


def test_no_removed_kernel_package():
    with pytest.raises(ImportError):
        __import__("basic_sparse_matrix_tpu.ops.pallas")


# ---- supernodal modes and their config ------------------------------------
@pytest.mark.parametrize("field,value", [
    ("supernodal_gather", "kernel"), ("supernodal_scatter", "vmem"),
    ("supernodal_scatter", "pallas"), ("matmul_precision", "fast")])
def test_config_rejects_removed_modes(field, value):
    with pytest.raises(ConfigError, match=field):
        C.Config(**{field: value})


@pytest.mark.parametrize("field", ["ell_stream", "ell_stream_unroll",
                                   "bsr_min_fill"])
def test_config_has_no_removed_kernel_knobs(field):
    with pytest.raises(TypeError):
        C.Config(**{field: 1})


def test_config_env_rejects_removed_mode(monkeypatch):
    monkeypatch.setenv("BSM_SUPERNODAL_SCATTER", "vmem")
    with pytest.raises(ConfigError):
        C.Config.from_env()


def _lap3d_nd(k):
    from basic_sparse_matrix_tpu.ops.generators import laplacian_3d
    from basic_sparse_matrix_tpu.ops.reorder import (
        nd_permutation,
        permute_symmetric,
    )

    a = laplacian_3d(k)
    return permute_symmetric(a, nd_permutation(a))


@pytest.fixture(scope="module")
def sched10():
    from basic_sparse_matrix_tpu.models.supernodal import analyze_supernodal

    a = _lap3d_nd(10)
    return a, analyze_supernodal(a, relax=8)


@pytest.mark.parametrize("gather", ["auto", "element", "window"])
@pytest.mark.parametrize("scatter", ["auto", "element", "delta"])
def test_routing_yields_only_xla_modes(sched10, gather, scatter):
    from basic_sparse_matrix_tpu.models import supernodal as sn

    _, sched = sched10
    for gi in range(sched.n_groups):
        assert sn._group_delta(sched, gi, scatter) in ("element", "delta")
        assert sn._group_window(sched, gi, gather) in (True, False)


@pytest.mark.parametrize("gather,scatter", [
    ("window", "element"), ("element", "delta"), ("window", "delta"),
    ("auto", "auto")])
def test_factor_modes_agree_phase_b_pattern(sched10, gather, scatter):
    """Element vs window reads and element vs delta scatters give the same
    factor of the ND-ordered 7-point Laplacian (phase B's pattern, k=10),
    and it is the dense Cholesky factor."""
    from basic_sparse_matrix_tpu.models import supernodal as sn

    a, sched = sched10
    ref = np.asarray(sn._factorize_supernodal_whole(
        sched, a.values, "element", "element"))
    got = np.asarray(sn._factorize_supernodal_whole(
        sched, a.values, gather, scatter))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    l = sn.assemble_factor(a, got, sched)
    dense = np.linalg.cholesky(np.asarray(a.todense(), np.float64))
    np.testing.assert_allclose(np.asarray(l.todense()), dense,
                               rtol=1e-4, atol=1e-5)


# ---- native library, precision --------------------------------------------
def test_native_library_named_by_source_hash():
    path = symbolic.so_path()
    assert os.path.basename(path).startswith("csparse-")
    assert symbolic.so_path() == path
    assert symbolic.native_lib() is not None and os.path.exists(path)


def test_factor_precision_follows_config():
    old = C.get_config()
    try:
        for value in ("highest", "default"):
            C.set_config(dataclasses.replace(old, matmul_precision=value))
            with C.factor_precision():
                assert jax.config.jax_default_matmul_precision == value
    finally:
        C.set_config(old)
