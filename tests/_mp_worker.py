"""Rank entry-point for tests/test_multiprocess.py.

Each rank is a REAL separate OS process with 4 virtual CPU devices; two
ranks form an 8-device, 2-process job — the smallest faithful model of a
multi-host cluster (successor of the reference's single-process
SparseMatPar, src/sparsemat_par.rs:37-68).  CPU only: a second process
could not get a GPU's memory while another holds it.

Usage: python _mp_worker.py <rank> <nprocs> <port>
Prints "MP_OK <max_abs_err>" on success.
"""
import os
import sys


def main():
    rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_ENABLE_X64"] = "1"

    import numpy as np
    import scipy.sparse as sp

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from jax.experimental import multihost_utils

    import sparsemat_tpu as smt
    from sparsemat_tpu import parallel, solvers
    from sparsemat_tpu.parallel.multihost import (
        init_distributed, make_host_mesh, make_mesh_2d, process_info)

    init_distributed(f"127.0.0.1:{port}", nprocs, rank)
    info = process_info()
    assert info["process_count"] == nprocs, info
    assert info["global_devices"] == 4 * nprocs, info

    # the 2-D (hosts × chips) mesh must also construct cleanly
    mesh2 = make_mesh_2d()
    assert mesh2.shape == {"hosts": nprocs, "chips": 4}, mesh2.shape

    # 2-D 5-point Poisson, distributed over the host-major row mesh
    n = 24
    m = n * n
    main_d = 4.0 * np.ones(m)
    off1 = -np.ones(m - 1)
    off1[n - 1::n] = 0.0  # no coupling across grid-row boundaries
    offn = -np.ones(m - n)
    lap = sp.diags([main_d, off1, off1, offn, offn], [0, 1, -1, n, -n],
                   format="csr").astype(np.float32)

    mesh = make_host_mesh()
    dia = smt.CSR.from_scipy(lap).to_dia()
    dA = parallel.distribute_dia(dia, mesh)

    rng = np.random.default_rng(0)
    x_ref = rng.standard_normal(m).astype(np.float32)

    # distributed SpMV vs scipy
    xs = dA.padded_vector(x_ref, mesh)
    y = dA.unpad(dA.matvec(xs, mesh))
    y_host = np.asarray(multihost_utils.process_allgather(y, tiled=True))
    err_spmv = np.abs(y_host - lap @ x_ref).max()
    assert err_spmv < 1e-4, f"dist spmv err {err_spmv}"

    # distributed CG vs scipy dense solve
    b = np.ones(m, np.float32)
    bs = dA.padded_vector(b, mesh)
    x, sinfo = solvers.cg(lambda v: dA.matvec(v, mesh), bs, tol=1e-6,
                          maxiter=4000)
    x_host = np.asarray(
        multihost_utils.process_allgather(dA.unpad(x), tiled=True))
    ref = sp.linalg.spsolve(lap.astype(np.float64).tocsc(),
                            b.astype(np.float64))
    err_cg = np.abs(x_host - ref).max()
    assert bool(sinfo.converged), "CG did not converge"
    assert err_cg < 1e-3, f"dist CG err {err_cg}"

    multihost_utils.sync_global_devices("sparsemat_mp_done")
    print(f"MP_OK {max(err_spmv, err_cg):.3e}", flush=True)


if __name__ == "__main__":
    main()
