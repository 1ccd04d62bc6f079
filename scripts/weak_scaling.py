#!/usr/bin/env python
"""Weak-scaling harness: distributed CG throughput as devices grow with
problem size (BASELINE north star: >= 80% efficiency 1 host -> N hosts).

Per device count P it builds a 2-D Poisson system with ROWS_PER_DEV * P
rows, distributes it over a P-device row mesh (DistDIA halo exchange +
psum dots), times a fixed number of CG iterations, and reports
iterations/s and efficiency vs P=1.

Runs anywhere:
  * GPUs of one host:  python scripts/weak_scaling.py (one process drives
    every visible card).
  * several hosts:  one process per host with
    --multihost HOST:PORT,N_PROCESSES,PROCESS_ID.
  * CPU simulation:  JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/weak_scaling.py
Emits one JSON line: {"weak_scaling": {P: iters_per_s}, "efficiency": ...}.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp


def poisson2d(n: int) -> sp.csr_matrix:
    m = n * n
    main_d = 4.0 * np.ones(m)
    off1 = -np.ones(m - 1)
    off1[n - 1::n] = 0.0
    offn = -np.ones(m - n)
    return sp.diags([main_d, off1, off1, offn, offn], [0, 1, -1, n, -n],
                    format="csr").astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-dev", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--multihost", metavar="HOST:PORT,N,ID",
                    help="join an N-process job as process ID before "
                         "building meshes")
    args = ap.parse_args()

    import jax

    if args.multihost:
        from sparsemat_tpu.parallel.multihost import init_distributed

        addr, nproc, pid = args.multihost.split(",")
        init_distributed(addr, int(nproc), int(pid))

    import sparsemat_tpu as smt
    from sparsemat_tpu import parallel, solvers

    n_dev = len(jax.devices())
    results = {}
    sizes = [p for p in (1, 2, 4, 8, 16, 32) if p <= n_dev]
    for P in sizes:
        side = max(int(np.sqrt(args.rows_per_dev * P)), 4)
        A = poisson2d(side)
        mesh = parallel.make_mesh(P)
        dA = parallel.distribute_dia(smt.CSR.from_scipy(A).to_dia(), mesh)
        b = np.ones(A.shape[0], np.float32)
        bs = dA.padded_vector(b, mesh)

        run = jax.jit(lambda rhs: solvers.cg(
            lambda v: parallel.dist_dia_spmv(dA, v, mesh), rhs,
            tol=0.0, maxiter=args.iters)[0])
        run(bs).block_until_ready()
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            run(bs).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        ips = args.iters / best
        results[P] = round(ips, 2)
        print(f"P={P:3d}  rows={A.shape[0]:>10,}  {ips:9.1f} CG iters/s",
              file=sys.stderr, flush=True)

    base = results[sizes[0]]
    eff = {P: round(results[P] / base, 4) for P in sizes}
    out = {"rows_per_dev": args.rows_per_dev,
           "weak_scaling_iters_per_s": results,
           "efficiency_vs_1dev": eff}
    if jax.devices()[0].platform == "cpu":
        out["note"] = ("virtual CPU devices share one physical CPU — "
                       "efficiency here only checks the code path, not "
                       "scaling; run on GPUs for real numbers")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
