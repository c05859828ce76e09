"""chip_smoke.py on the CPU: the platform guard, and every phase function at
tiny sizes against its host reference (the full sizes run on the GPU)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from basic_sparse_matrix_tpu.utils import config as _cfg  # noqa: E402


@pytest.fixture
def mesh4():
    from basic_sparse_matrix_tpu.parallel.mesh import row_mesh

    return row_mesh(4)


@pytest.fixture
def nd_ordering():
    """Small 3D Laplacians pick RCM + the banded tier; force nested
    dissection so the tiny phase-B case takes the supernodal path like
    the full-size one."""
    old = _cfg.get_config()
    _cfg.set_config(dataclasses.replace(old, ordering="nd"))
    yield
    _cfg.set_config(old)


@pytest.mark.parametrize("count", [1, 4])
def test_require_gpu_raises_off_gpu(count):
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(count)


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(RuntimeError):
        chip_smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied out of the repo, the script finds neither a GPU nor the
    library: it exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_a_tiny():
    out = chip_smoke.phase_a(3, rows=3000, per_row=8, n_rhs=24, n_check=64)
    assert out["rows_checked"] == 64
    assert out["rel_max_err"] <= 1e-4


def test_phase_b_tiny(nd_ordering):
    out = chip_smoke.phase_b(1, k=10, n_rhs=(1, 3))
    assert out["kind"] == "supernodal" and out["n"] == 1000
    for m in (1, 3):
        assert out[f"rhs{m}"]["rel_residual"] <= 1e-4


def test_phase_b_rejects_wrong_kind():
    # without ND the tiny problem lands on the banded tier
    with pytest.raises(AssertionError, match="solver kind"):
        chip_smoke.phase_b(1, k=6, n_rhs=(1,))


def test_phase_c_tiny():
    out = chip_smoke.phase_c(2, n=80, sd_inserts=4000, add_inserts=3000,
                             mul_inserts=2000, n_rhs=16)
    assert set(out) >= {"sd_mul", "ss_add", "ss_mul"}


@pytest.mark.parametrize("bump", [1e-2, np.nan])
def test_sampled_row_check_catches_errors(bump):
    import jax.numpy as jnp

    a, cols, vals = chip_smoke.hypersparse_csr(500, 4, 0)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(
        (500, 8)).astype(np.float32))
    from basic_sparse_matrix_tpu.ops import spmm_auto

    c = spmm_auto(a, b)
    chip_smoke.check_sampled_rows("ok", c, b, cols, vals, 500, 0)
    bad = c.at[17, 3].add(bump * float(jnp.abs(c).max()))
    with pytest.raises(AssertionError):
        chip_smoke.check_sampled_rows("bad", bad, b, cols, vals, 500, 0)


def test_exact_check_catches_one_entry():
    ref = np.arange(12.0).reshape(3, 4)
    chip_smoke._exact("ok", ref.astype(np.float32), ref)
    got = ref.copy()
    got[2, 1] += 1
    with pytest.raises(AssertionError, match="1 entries"):
        chip_smoke._exact("bad", got, ref)


def test_multi_matmul_four_devices(mesh4):
    out = chip_smoke.multi_matmul(mesh4, 5, rows=4001, per_row=6,
                                  n_rhs=16, n_check=128)
    assert out["devices"] == 4 and out["rel_max_err"] <= 1e-4


def test_multi_pcg_four_devices(mesh4):
    out = chip_smoke.multi_pcg(mesh4, 2, k=8, iters=80)
    assert out["devices"] == 4 and out["rel_residual"] <= 1e-5
    assert out["block_rows"] == 128


def test_multi_spgemm_four_devices(mesh4):
    out = chip_smoke.multi_spgemm(mesh4, k=7)
    assert out["devices"] == 4 and out["n"] == 343
