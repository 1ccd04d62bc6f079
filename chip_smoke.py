#!/usr/bin/env python
"""Smoke test of sparsemat_tpu on an NVIDIA GPU, through the public API.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the distributed CG and
                                    # SpMV paths and their references only

Each phase prints one line: what ran, its size, the tolerance, the error
measured and the seconds taken.  Any failed check raises, so the process
exits non-zero before the last line.  The last line of standard output is
one JSON object naming the device as JAX reports it:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

With no GPU (e.g. ``JAX_PLATFORMS=cpu``) it exits 1 before any phase.
All data comes from fixed seeds; one process drives every card.
"""

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))

#: grid sides / row counts of the phases (a CPU rehearsal shrinks them)
N_BANDED = 1 << 24      # banded SpMV rows: 335 MB of diagonals, past L2
N_CG32 = 2048           # f32 CG grid side: 4.2M rows
N_CG64 = 1024           # f64 CG, PCG, GMRES grid side: 1.05M rows
N_MULTI = 8192          # four-card CG grid side: 67.1M rows, 1.3 GB


def require_gpu(count: int):
    """The JAX devices, or exit 1 when they are not ``count`` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU; JAX found platform "
              f"{devs[0].platform!r} ({devs[0].device_kind})", file=sys.stderr)
        sys.exit(1)
    if len(devs) < count:
        print(f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        sys.exit(1)
    return devs


def report(name, what, size, tol, err, t0):
    print(f"phase {name}: {what} | size {size} | tol {tol:.1e} | "
          f"err {err:.3e} | {time.perf_counter() - t0:.2f} s", flush=True)
    if not err <= tol:
        raise RuntimeError(f"phase {name}: error {err:.3e} > tolerance {tol:.1e}")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# --- host references (numpy / scipy, independent of the library) ------------

def poisson_apply(x, n):
    """y = A x for the 2D 5-point Poisson matrix on an n×n grid, in the
    dtype of ``x`` (numpy stencil — the plain reference)."""
    u = x.reshape(n, n)
    y = 4.0 * u
    y[1:, :] -= u[:-1, :]
    y[:-1, :] -= u[1:, :]
    y[:, 1:] -= u[:, :-1]
    y[:, :-1] -= u[:, 1:]
    return y.reshape(-1)


def poisson_scipy(n, dtype):
    import scipy.sparse as sp

    m = n * n
    e1 = np.ones(m - 1)
    e1[np.arange(1, m) % n == 0] = 0.0
    return sp.diags([-np.ones(m - n), -e1, 4.0 * np.ones(m), -e1,
                     -np.ones(m - n)], [-n, -1, 0, 1, n],
                    format="csr").astype(dtype)


def manufactured_rhs(n, seed):
    """Unit-norm b = A x_true (f64) for a random x_true.  A random b would
    put most of its weight on the smooth modes, where float32 CG's true
    residual stalls near 4e-5 of ‖b‖ even at 256² (measured on the CPU);
    b = A x_true keeps ‖A‖‖x‖/‖b‖ small, so float32 reaches 1e-6."""
    x_true = np.random.default_rng(seed).standard_normal(n * n)
    b = poisson_apply(x_true, n)
    return b / np.linalg.norm(b)


def rel_residual(b, x, n):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(b - poisson_apply(x, n)) / np.linalg.norm(b)


def poisson_dia_data(n, dtype=np.float32):
    """(5, n²) diagonals of the 2D Poisson matrix, offsets (-n,-1,0,1,n)."""
    m = n * n
    i = np.arange(m)
    return np.stack([np.where(i >= n, -1.0, 0.0),
                     np.where(i % n != 0, -1.0, 0.0),
                     np.full(m, 4.0),
                     np.where(i % n != n - 1, -1.0, 0.0),
                     np.where(i < m - n, -1.0, 0.0)]).astype(dtype)


# --- one-card phases ---------------------------------------------------------

def phase_assembly():
    import jax.numpy as jnp
    import scipy.sparse as sp

    import sparsemat_tpu as smt
    from sparsemat_tpu import native

    t0 = time.perf_counter()
    check(native.native_available(),
          "assembly: the native C++ store did not build or load")
    n_ins, dim = 2_000_000, 100_000
    rng = np.random.default_rng(5)
    ir = rng.integers(0, dim, n_ins)
    ic = rng.integers(0, dim, n_ins)
    iv = rng.standard_normal(n_ins)
    builder = smt.SparseBuilder()
    check(type(builder._store).__name__ == "_NativeStore",
          f"assembly: builder uses {type(builder._store).__name__}")
    builder.add_batch(ir, ic, iv)
    A = builder.to_csr()
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = np.asarray(smt.spmv(A, jnp.asarray(x)))
    ref_m = sp.coo_matrix((iv, (ir, ic)), shape=A.shape).tocsr()
    ref = ref_m @ x.astype(np.float64)
    # f32 sums of ~20 products of unit-scale values: rounding ~1e-6 relative
    err = np.abs(y - ref).max() / np.abs(ref).max()
    report("assembly", f"SparseBuilder.add_batch → to_csr → spmv (C++ store, "
           f"{A.nse:,} entries)", f"{n_ins:,} inserts into {dim:,}²", 1e-5,
           err, t0)


def phase_banded_spmv():
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt

    t0 = time.perf_counter()
    n = N_BANDED
    offsets = (-4096, -1, 0, 1, 4096)

    @jax.jit
    def build(key):
        idx = jnp.arange(n, dtype=jnp.int32)
        rows = []
        for k, off in enumerate(offsets):
            v = jax.random.normal(jax.random.fold_in(key, k), (n,), jnp.float32)
            rows.append(jnp.where((idx + off >= 0) & (idx + off < n), v, 0))
        return jnp.stack(rows)

    A = smt.DIA(data=build(jax.random.PRNGKey(0)), offsets=offsets,
                shape=(n, n))
    x = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float32)
    y = jax.jit(smt.spmv)(A, x)
    y.block_until_ready()
    # sampled windows (start, middle, end) against a float64 numpy product
    err = 0.0
    for lo in (0, n // 3, n - 2048):
        hi = lo + 2048
        ref = np.zeros(hi - lo)
        for d, off in enumerate(offsets):
            src = np.arange(lo, hi) + off
            ok = (src >= 0) & (src < n)
            dd = np.asarray(A.data[d, lo:hi], np.float64)
            xs = np.asarray(x[np.clip(src, 0, n - 1)], np.float64)
            ref[ok] += dd[ok] * xs[ok]
        ys = np.asarray(y[lo:hi], np.float64)
        err = max(err, np.abs(ys - ref).max() / np.abs(ref).max())
    # 5 f32 products per row: rounding ~3e-7 of max|y|
    report("banded_spmv", f"spmv on a device-built DIA {offsets} "
           f"({A.data.nbytes/1e6:.0f} MB of diagonals)", f"{n:,} rows",
           1e-5, err, t0)


def phase_cg_f32():
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt
    from sparsemat_tpu import solvers

    t0 = time.perf_counter()
    n = N_CG32
    A = smt.auto_format(smt.CSR.from_scipy(poisson_scipy(n, np.float32)))
    print(f"  auto_format(Poisson {n}²) → {type(A).__name__}", flush=True)
    check(isinstance(A, smt.DIA), f"auto_format chose {type(A).__name__}, "
          "not DIA, for the 5-point stencil")
    b = manufactured_rhs(n, seed=2)
    x, info = jax.jit(lambda a, r: solvers.cg(a, r, tol=0.0, rtol=1e-6,
                                              maxiter=20_000))(
        A, jnp.asarray(b, jnp.float32))
    check(bool(info.converged), f"cg f32 did not converge "
          f"({int(info.iterations)} iters)")
    # rtol 1e-6 on float32 iterates; the f64 true residual may sit up to
    # ~10x above it (residual-recurrence drift), never 1e-5
    report("cg_f32", f"auto_format → solvers.cg rtol 1e-6, "
           f"{int(info.iterations)} iters, host f64 ‖b−Ax‖/‖b‖",
           f"{n*n:,} rows", 1e-5, rel_residual(b, x, n), t0)


def phase_cg_f64():
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt
    from sparsemat_tpu import solvers

    t0 = time.perf_counter()
    n = N_CG64
    b = manufactured_rhs(n, seed=3)
    with jax.enable_x64(True):
        A64 = smt.auto_format(smt.CSR.from_scipy(poisson_scipy(n, np.float64)))
        check(isinstance(A64, smt.DIA) and A64.data.dtype == jnp.float64,
              f"f64 auto_format gave {type(A64).__name__}")
        b64 = jnp.asarray(b, jnp.float64)
        x, info = jax.jit(lambda a, r: solvers.cg(a, r, tol=1e-8,
                                                  maxiter=20_000))(A64, b64)
        check(bool(info.converged) and x.dtype == jnp.float64,
              "cg f64 did not converge in f64")
        err = rel_residual(b, x, n)
        its = int(info.iterations)
        t_cg = time.perf_counter()
        A32 = A64.astype(jnp.float32)
        xr, rinfo = solvers.refine(A64, b64, A_low=A32, tol=1e-8,
                                   inner_rtol=1e-2, inner_maxiter=6000,
                                   max_outer=60)
        err_r = rel_residual(b, xr, n)
    # unit-norm b: CG's 1e-8 absolute tolerance is also the relative one,
    # and the host recomputes the float64 residual it promises
    print(f"phase cg_f64: jax.enable_x64 → auto_format → solvers.cg tol 1e-8, "
          f"{its} iters | size {n*n:,} rows | tol {1e-8:.1e} | err {err:.3e} | "
          f"{t_cg - t0:.2f} s", flush=True)
    check(err <= 1e-8, f"phase cg_f64: error {err:.3e} > tolerance 1e-8")
    # refine stops on its own float64 recomputed residual
    report("refine", f"solvers.refine f64 outer / f32 inner CG, "
           f"{int(rinfo.iterations)} inner iters", f"{n*n:,} rows", 1e-8,
           err_r, t_cg)


def phase_pcg_gmres():
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt
    from sparsemat_tpu import solvers

    n = N_CG64
    b = manufactured_rhs(n, seed=4)
    A = smt.auto_format(smt.CSR.from_scipy(poisson_scipy(n, np.float32)))
    bj = jnp.asarray(b, jnp.float32)
    rtol = 1e-5      # each solver's own stopping tolerance, held on the host
    t0 = time.perf_counter()
    M = solvers.BlockJacobiPreconditioner.from_matrix(A, block_size=64)
    x, info = jax.jit(lambda a, r: solvers.cg(a, r, tol=0.0, rtol=rtol, M=M,
                                              maxiter=20_000))(A, bj)
    check(bool(info.converged), "block-Jacobi PCG did not converge")
    report("pcg", f"solvers.cg(M=BlockJacobi(64)) rtol {rtol:.0e}, "
           f"{int(info.iterations)} iters", f"{n*n:,} rows", rtol,
           rel_residual(b, x, n), t0)
    t0 = time.perf_counter()
    x, info = jax.jit(lambda a, r: solvers.gmres(a, r, tol=0.0, rtol=rtol,
                                                 restart=30,
                                                 maxiter=20_000))(A, bj)
    check(bool(info.converged), "GMRES did not converge")
    report("gmres", f"solvers.gmres(restart=30) rtol {rtol:.0e}, "
           f"{int(info.iterations)} iters", f"{n*n:,} rows", rtol,
           rel_residual(b, x, n), t0)


def _fem_and_circuit():
    from sparsemat_tpu import matgen

    fem = (matgen.fem_block_band() * np.float32(2e-2)).astype(np.float32).tocsr()
    circ = (matgen.circuit_scatter() * np.float32(2e-2)).astype(np.float32).tocsr()
    return fem, circ


def _spmv_err(mat, spm, seed):
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt

    x = np.random.default_rng(seed).standard_normal(spm.shape[1]).astype(np.float32)
    y = np.asarray(jax.jit(smt.spmv)(mat, jnp.asarray(x)), np.float64)
    ref = spm.astype(np.float64) @ x.astype(np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


def phase_scattered_spmv(fem, circ):
    import sparsemat_tpu as smt
    from sparsemat_tpu import io as smtio

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "fem.mtx")
        smtio.save_mtx(smt.CSR.from_scipy(fem), path)
        fem_csr = smtio.load_mtx(path, dtype=np.float32)
    check(smtio.last_mtx_parser == "native",
          f"load_mtx used the {smtio.last_mtx_parser} parser, not the C++ one")
    out = {}
    # scatter-add sums rows in an order that changes from run to run:
    # float32 rounding of ~53 (fem) or up to ~3400 (scircuit) products
    for name, spm, csr in (("fem_217k", fem, fem_csr),
                           ("scircuit_171k", circ, smt.CSR.from_scipy(circ))):
        t1 = time.perf_counter()
        mat = smt.auto_format(csr)
        print(f"  auto_format({name}) → {type(mat).__name__}", flush=True)
        report(f"spmv_{name}", f"{type(mat).__name__} spmv"
               + (" (.mtx save/load, C++ parser)" if name == "fem_217k" else ""),
               f"{spm.shape[0]:,} rows, {spm.nnz:,} nnz", 1e-5,
               _spmv_err(mat, spm, 6), t1 if name != "fem_217k" else t0)
        out[name] = csr
    return out


def phase_spmm(fem, fem_csr):
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt

    t0 = time.perf_counter()
    m = 128
    B = np.random.default_rng(7).standard_normal((fem.shape[1], m)).astype(np.float32)
    mat = smt.BSR.from_csr_device(fem_csr, br=512, bc=128)
    Y = np.asarray(jax.jit(smt.spmm)(mat, jnp.asarray(B))[:256], np.float64)
    ref = fem[:256].astype(np.float64) @ B.astype(np.float64)
    # true-f32 products (Precision.HIGHEST): ~1e-6; TF32 would give ~1e-3
    report("spmm", f"BSR(512×128).from_csr_device → spmm, m={m}, first 256 "
           "rows", f"{fem.shape[0]:,} rows, {mat.n_tiles:,} blocks", 1e-5,
           np.abs(Y - ref).max() / np.abs(ref).max(), t0)


def phase_spgemm(fem, circ):
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt

    for name, spm in (("fem_217k", fem), ("scircuit_171k", circ)):
        t0 = time.perf_counter()
        A = smt.CSR.from_scipy(spm)
        C = smt.spgemm(A, A)
        v = np.random.default_rng(8).standard_normal(spm.shape[1]).astype(np.float32)
        cv = np.asarray(jax.jit(smt.spmv)(C, jnp.asarray(v)), np.float64)
        s64 = spm.astype(np.float64)
        rv = s64 @ (s64 @ v.astype(np.float64))
        # f32 products summed twice (C's entries, then C v)
        report(f"spgemm_{name}", f"spgemm(A, A) → C v vs A (A v), "
               f"{int(C.nse):,} out entries", f"{spm.shape[0]:,} rows", 1e-5,
               np.abs(cv - rv).max() / np.abs(rv).max(), t0)


def phase_gpu_tests(dev):
    """The tests marked ``gpu`` (tests/test_gpu.py), called in this
    process: a second process could not get the card's memory."""
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    import test_gpu

    for name in sorted(n for n in dir(test_gpu) if n.startswith("test_")):
        t0 = time.perf_counter()
        getattr(test_gpu, name)(dev)          # asserts rel err < 1e-5
        print(f"phase gpu_test {name}: tests/test_gpu.py (gpu marker) | "
              f"tol 1.0e-05 vs float64 | passed | "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


def run_single(devs):
    phase_assembly()
    phase_banded_spmv()
    phase_cg_f32()
    phase_cg_f64()
    phase_pcg_gmres()
    fem, circ = _fem_and_circuit()
    csrs = phase_scattered_spmv(fem, circ)
    phase_spmm(fem, csrs["fem_217k"])
    phase_spgemm(fem, circ)
    phase_gpu_tests(devs[0])


# --- four-card phase -----------------------------------------------------------

def run_multi(devs):
    import jax
    import jax.numpy as jnp

    import sparsemat_tpu as smt
    from sparsemat_tpu import parallel, solvers

    mesh = parallel.make_mesh(4)
    check(mesh.devices.size == 4, f"mesh has {mesh.devices.size} devices")

    def in_use():
        """bytes_in_use per card (shard bytes stand in on the CPU backend
        of a rehearsal, which keeps no memory stats)."""
        gc.collect()
        stats = [d.memory_stats() for d in mesh.devices.flat]
        return None if stats[0] is None else [st["bytes_in_use"] for st in stats]

    def balanced(arrays, what, before):
        """Every array spans the 4 cards, and both its shard bytes and the
        bytes_in_use it added to each card (over ``before``) are within 2x
        across cards."""
        shard = {d: 0 for d in mesh.devices.flat}
        for a in arrays:
            ds = a.sharding.device_set
            check(len(ds) == 4, f"{what}: array on {len(ds)} devices, not 4")
            for sh in a.addressable_shards:
                shard[sh.device] += sh.data.nbytes
        sb = list(shard.values())
        check(max(sb) <= 2 * min(sb), f"{what}: shard bytes {sb} differ by > 2x")
        now = in_use()
        if now is None:
            return sb
        used = [u - b for u, b in zip(now, before)]
        check(min(used) > 0 and max(used) <= 2 * min(used),
              f"{what}: bytes_in_use added per card {used} differ by > 2x")
        return used

    # (a) distributed CG vs single-card CG on 8192² Poisson (67.1M rows)
    n = N_MULTI
    t0 = time.perf_counter()
    data = poisson_dia_data(n)
    b = manufactured_rhs(n, seed=9)
    before = in_use()
    dia = smt.DIA(data=jnp.asarray(data), offsets=(-n, -1, 0, 1, n),
                  shape=(n * n, n * n))
    dA = parallel.distribute_dia(dia, mesh)
    del dia                                   # free the one-card copy
    bs = dA.padded_vector(b.astype(np.float32), mesh)
    used = balanced([dA.data, bs], "distribute_dia", before)
    rtol = 1e-6
    xd, infod = jax.jit(lambda m, r: solvers.cg(
        lambda v: m.matvec(v, mesh), r, tol=0.0, rtol=rtol,
        maxiter=20_000))(dA, bs)
    xd.block_until_ready()
    check(bool(infod.converged), "distributed CG did not converge")
    check(len(xd.sharding.device_set) == 4, "CG iterate not on 4 devices")
    xd = np.asarray(dA.unpad(xd))
    err_d = rel_residual(b, xd, n)
    report("dist_cg", f"distribute_dia + solvers.cg rtol {rtol:.0e}, "
           f"{int(infod.iterations)} iters, host f64 ‖b−Ax‖/‖b‖; "
           f"bytes_in_use added/card {[round(u/1e9, 2) for u in used]} GB",
           f"{n*n:,} rows, {data.nbytes/1e9:.2f} GB diagonals", 1e-5, err_d,
           t0)
    del dA, bs

    t0 = time.perf_counter()
    dia1 = smt.DIA(data=jax.device_put(data, devs[0]), offsets=(-n, -1, 0, 1, n),
                   shape=(n * n, n * n))
    x1, info1 = jax.jit(lambda a, r: solvers.cg(a, r, tol=0.0, rtol=rtol,
                                                maxiter=20_000))(
        dia1, jax.device_put(b.astype(np.float32), devs[0]))
    x1 = np.asarray(x1)
    del dia1
    d_it = abs(int(info1.iterations) - int(infod.iterations))
    check(d_it <= 1, f"iteration counts differ: one card "
          f"{int(info1.iterations)}, four {int(infod.iterations)}")
    # the same float32 iteration with reductions summed in another order
    report("dist_cg_vs_one_card", f"‖x4 − x1‖/‖x1‖, iters one card "
           f"{int(info1.iterations)} vs four {int(infod.iterations)}",
           f"{n*n:,} rows", 1e-5,
           np.linalg.norm(xd - x1) / np.linalg.norm(x1), t0)

    # (b) distributed SpMV on fem_217k, three exchange patterns
    from sparsemat_tpu import matgen

    fem = (matgen.fem_block_band() * np.float32(2e-2)).astype(np.float32).tocsr()
    x = np.random.default_rng(10).standard_normal(fem.shape[1]).astype(np.float32)
    ref = fem.astype(np.float64) @ x.astype(np.float64)
    # one distribution alive at a time, so each is measured on its own
    for name, make in (("distribute_csr", parallel.distribute_csr),
                       ("distribute_csr_subset", parallel.distribute_csr_subset),
                       ("distribute_slab", parallel.distribute_slab)):
        t0 = time.perf_counter()
        before = in_use()
        csr = smt.CSR.from_scipy(fem)
        dm = make(csr, mesh)               # reads csr's host-side arrays
        del csr     # the input CSR lives on card 0; only the shards stay
        xs = dm.padded_vector(x, mesh)
        y = jax.jit(lambda m, v: m.matvec(v, mesh))(dm, xs)
        leaves = [a for a in jax.tree_util.tree_leaves(dm) if a.ndim] + [y]
        used = balanced(leaves, name, before)
        y = np.asarray(dm.unpad(y), np.float64)
        del dm, xs, leaves
        report(f"dist_spmv {name}", f"matvec on 4 cards vs scipy; "
               f"bytes_in_use added/card {[round(u/1e6, 1) for u in used]} MB",
               f"{fem.shape[0]:,} rows, {fem.nnz:,} nnz", 1e-5,
               np.abs(y - ref).max() / np.abs(ref).max(), t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card distributed phases only")
    args = ap.parse_args()
    count = 4 if args.multi else 1
    devs = require_gpu(count)

    from sparsemat_tpu.utils import card_name_and_power_limit, enable_compile_cache

    enable_compile_cache()
    print(f"devices: {devs}", flush=True)
    print(card_name_and_power_limit(), flush=True)
    t0 = time.perf_counter()
    (run_multi if args.multi else run_single)(devs)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
