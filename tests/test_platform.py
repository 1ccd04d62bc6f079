"""The platform contract: no TPU-only module on any SpMV/SpMM path, true-f32
contractions, the compile-cache location, the device peaks table and
``chip_smoke.py``'s refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu import solvers, vectors
from sparsemat_tpu.kernels.spmm import bsr_spmm_xla
from sparsemat_tpu.ops import algebra
from sparsemat_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_chip_smoke_refuses_cpu_backend():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=_cpu_env(), cwd=REPO)
    assert out.returncode != 0
    assert "needs a CUDA GPU" in out.stderr
    assert "phase" not in out.stdout and '"ok"' not in out.stdout


def test_chip_smoke_multi_refuses_cpu_backend():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                          "--multi"], capture_output=True, text=True,
                         timeout=120, env=_cpu_env(), cwd=REPO)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert profiling.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_enable_compile_cache_sets_only_the_env_dir(tmp_path):
    code = ("import jax; from sparsemat_tpu.utils import enable_compile_cache;"
            "p = enable_compile_cache();"
            "print(p == jax.config.jax_compilation_cache_dir, p)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", str(tmp_path)]


def test_spmv_spmm_every_format_imports_no_tpu_module():
    code = r"""
import sys
import numpy as np, scipy.sparse as sp
import sparsemat_tpu as smt
m = sp.random(300, 300, 0.03, random_state=0, format="csr", dtype=np.float32)
m = (m + sp.eye(300, dtype=np.float32, format="csr")).tocsr()
c = smt.CSR.from_scipy(m)
x = np.ones(300, np.float32)
B = np.ones((300, 3), np.float32)
band = smt.CSR.from_scipy(sp.diags([1.0, 2.0, 3.0], [-1, 0, 5], shape=(300, 300),
                                   format="csr", dtype=np.float32))
mats = [c, c.to_coo(), band.to_dia(), c.to_ell(), smt.SELL.from_csr(c),
        c.to_gell(), c.to_well(), c.to_slab(), c.to_slab_pack(),
        c.to_slab_stream(), c.to_strip(), c.to_route(), smt.BSR.from_csr(c)]
for a in mats:
    smt.spmv(a, x); smt.spmm(a, B); smt.spmv_dot(a, x); smt.spmv_chain(a, x, 2)
bad = sorted(k for k in sys.modules
             if k.startswith(("jax.experimental.pallas", "jax._src.pallas")))
print(len(mats), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=_cpu_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split(None, 1) == ["13", "[]\n"]


def _dot_precisions(fn, *args):
    """Precision of every dot_general in fn's jaxpr (nested jaxprs too)."""
    txt = str(jax.make_jaxpr(fn)(*args))
    blocks = txt.split("dot_general[")[1:]
    return [b.split("precision=")[1].split("\n")[0] for b in blocks]


def _all_highest(precs):
    return precs and all(p.count("HIGHEST") == 2 for p in precs)


def test_inner_products_carry_highest():
    a = jnp.ones(16, jnp.float32)
    assert _all_highest(_dot_precisions(vectors.inner_prod, a, a))
    dia = smt.CSR.from_scipy(sp.eye(16, format="csr", dtype=np.float32)).to_dia()
    assert _all_highest(_dot_precisions(
        lambda l, r: algebra.inner_prod(dia, l, r), a, a))


def test_gmres_projections_carry_highest():
    dia = smt.CSR.from_scipy(
        sp.diags([2.0, -1.0, -1.0], [0, 1, -1], shape=(32, 32),
                 format="csr", dtype=np.float32)).to_dia()
    b = jnp.ones(32, jnp.float32)
    precs = _dot_precisions(
        lambda r: solvers.gmres(dia, r, restart=4, maxiter=8)[0], b)
    assert len(precs) >= 3 and _all_highest(precs)


def test_block_jacobi_and_bsr_spmm_carry_highest():
    m = sp.random(64, 128, 0.2, random_state=1, format="csr", dtype=np.float32)
    m = (m + sp.eye(64, 128, dtype=np.float32, format="csr")).tocsr()
    sq = smt.CSR.from_scipy((m[:, :64] + sp.eye(64, format="csr")).tocsr())
    M = solvers.BlockJacobiPreconditioner.from_matrix(sq, block_size=16)
    r = jnp.ones(64, jnp.float32)
    assert _all_highest(_dot_precisions(M.apply, r))
    bsr = smt.BSR.from_csr(smt.CSR.from_scipy(m))
    B = jnp.ones((128, 4), jnp.float32)
    assert _all_highest(_dot_precisions(lambda x: bsr_spmm_xla(bsr, x), B))
    np.testing.assert_allclose(np.asarray(bsr_spmm_xla(bsr, B)),
                               m @ np.ones((128, 4)), rtol=1e-5, atol=1e-5)


def test_device_peaks_table():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    pk = profiling.device_peaks(Dev())
    assert pk["hbm_bw"] == 3.35e12 and pk["l2_bytes"] == 50e6
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks(jax.devices()[0])     # the CPU backend


def test_time_chained_op_runs_a_power_of_two_chain():
    calls = []

    def step(v):
        calls.append(1)            # traced once per compiled chain length
        return v * 0.5 + 1.0

    dt = profiling.time_chained_op(step, jnp.zeros(8), max_inner=64,
                                   reps=1)
    assert dt > 0 and len(calls) == 2      # probe chain + timed chain


def test_bench_refuses_unknown_device():
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                         capture_output=True, text=True, timeout=120,
                         env=_cpu_env(), cwd=REPO)
    assert out.returncode != 0
    assert "no published peaks" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_bench_result_names_the_device():
    code = ("import json, bench; bench.DETAIL.update(platform='gpu', "
            "device_kind='k', device_count=1); bench.emit_final()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=_cpu_env())
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["detail"]["device_kind"] == "k"
    assert res["metric"] == "spmv_banded_16M_fraction_of_hbm_peak"
