#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

The reference publishes no numbers (BASELINE.md).  The headline is the
HBM-bound banded SpMV's share of the card's published HBM bandwidth
(BASELINE.json north-star target: >= 0.70 of roofline nnz/s per chip);
``vs_baseline`` is that share over 0.70.  ``detail`` names the device
(platform, device_kind, count) and the card's power limit, and carries
every per-config number; progress goes to stderr.

Rooflines:
 * peaks come from ``sparsemat_tpu.utils.DEVICE_PEAKS``, keyed by
   ``device_kind``; an unknown device stops the run — no peak is assumed;
 * the same run measures an XLA copy and triad over >= 1 GB (far past the
   50 MB L2) — a kernel's share of those is reported beside its share of
   the published peak;
 * per-config traffic = ``mat.spmv_traffic_bytes()`` (the layout's
   lower-bound bytes).  Configs whose working set is under the 50 MB L2
   are L2 cells: they report time and rate, no HBM share.  A share above
   1.02 of the published peak is recorded as an invariant violation (a
   timer or traffic-model bug, never a claim).

Timing: ``sparsemat_tpu.utils.time_chained_op`` — K chained steps inside
one jitted ``fori_loop``, ``block_until_ready``, best of 3.

Delivery: the JSON line is emitted from a ``finally``/atexit/signal path,
and every config re-arms its own ``setitimer`` ceiling at min(cap,
remaining SPARSEMAT_BENCH_BUDGET), so one hang cannot starve the rest.

Configs (BASELINE.json):
 1. banded 1e4 rows, 5 diagonals, f32 — L2-resident single SpMV + chain
 2. banded DIA, 2^24 rows, 5 diagonals, f32 — HBM-bound HEADLINE
 3. CG on 2D 5-point Poisson — f32 512^2 / 2048^2; f64 1024^2 to 1e-8
    (native f64 CG, and mixed-precision refinement), in this process
 4. pwtk/scircuit-class surrogates through save_mtx/load_mtx: SpMV per
    layout, BSR SpMM (m=128), SpGEMM (A @ A); the scircuit generator at
    4M rows (scattered, past the L2) and two FEM surrogates whose ELL
    padding is under 2x (ELL against GELL)
 5. assembly inserts through the C++ hash store (host)
"""

import atexit
import functools
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# --- result delivery ---------------------------------------------------------

BUDGET = float(os.environ.get("SPARSEMAT_BENCH_BUDGET", "840"))
_T0 = time.monotonic()


def remaining() -> float:
    return BUDGET - (time.monotonic() - _T0)


RESULT = {
    "metric": "spmv_banded_16M_fraction_of_hbm_peak",
    "value": 0.0,
    "unit": "fraction",
    "vs_baseline": 0.0,  # target: >= 0.70 of the HBM roofline
    "detail": {},
}
DETAIL = RESULT["detail"]
VIOLATIONS = []
_emitted = False


def emit_final():
    global _emitted
    if _emitted:
        return
    _emitted = True
    if VIOLATIONS:
        DETAIL["invariant_violations"] = VIOLATIONS
        log("ERROR: roofline invariant violated — the timer or the traffic "
            f"model is wrong for: {VIOLATIONS}")
    DETAIL["bench_wall_s"] = round(time.monotonic() - _T0, 1)
    print(json.dumps(RESULT), flush=True)


class BenchTimeout(Exception):
    pass


def _sig_handler(signum, frame):
    raise BenchTimeout(f"signal {signum}")


def run_config(name, min_secs, fn, cap=420.0):
    """Run one config with failure isolation, a budget gate AND a hard
    per-config wall-clock ceiling (``setitimer`` re-armed per config)."""
    if remaining() < min_secs:
        log(f"SKIP {name}: {remaining():.0f}s budget left (< {min_secs})")
        DETAIL.setdefault("skipped_configs", []).append(name)
        return None
    t0 = time.monotonic()
    budget = min(float(cap), max(remaining(), 1.0))
    signal.setitimer(signal.ITIMER_REAL, budget)
    try:
        return fn()
    except BenchTimeout as e:
        log(f"{name} TIMED OUT at its {budget:.0f}s ceiling: {e}")
        DETAIL.setdefault("failed_configs", []).append(f"{name}:timeout")
        return None
    except Exception as e:  # a config failure is recorded, the rest run
        log(f"{name} FAILED: {type(e).__name__}: {str(e)[:300]}")
        DETAIL.setdefault("failed_configs", []).append(name)
        return None
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        log(f"  [{name}: {time.monotonic()-t0:.1f}s, "
            f"{max(remaining(), 0):.0f}s budget left]")


# --- rooflines -----------------------------------------------------------------

PEAK = {}    # filled in main(): published peaks of this device
COPY = {}    # filled in main(): measured copy/triad bytes/s


def hbm_share(name, bytes_moved, dt):
    """Share of the published HBM peak for an HBM cell; None for an L2
    cell (working set under the card's L2, 50 MB on the H100)."""
    if bytes_moved < PEAK["l2_bytes"]:
        return None
    frac = bytes_moved / dt / PEAK["hbm_bw"]
    if frac > 1.02:
        VIOLATIONS.append({"config": name, "fraction_of_peak": round(frac, 4)})
    DETAIL.setdefault("hbm_peak_fractions", {})[name] = round(frac, 4)
    if COPY.get("bw"):
        DETAIL.setdefault("copy_fractions", {})[name] = round(
            bytes_moved / dt / COPY["bw"], 4)
    return frac


def measure_copy_bw():
    """XLA copy (2 passes) and triad (3 passes) over 2^28 f32 = 1.07 GB per
    array — 20x the L2, so both stream from HBM."""
    from sparsemat_tpu.utils import time_chained_op

    n = 1 << 28
    x = jnp.ones((n,), jnp.float32)
    dt2 = time_chained_op(lambda v: v * np.float32(0.9999999), x)
    a = jnp.full((n,), 1e-9, jnp.float32)
    dt3 = time_chained_op(lambda v, aa: v * np.float32(0.9999999) + aa, x,
                          (a,))
    del x, a
    bw_copy = 2 * n * 4 / dt2
    bw_triad = 3 * n * 4 / dt3
    log(f"HBM probes (1.07 GB arrays): copy {bw_copy/1e9:.0f} GB/s, triad "
        f"{bw_triad/1e9:.0f} GB/s; published peak "
        f"{PEAK['hbm_bw']/1e9:.0f} GB/s")
    DETAIL["copy_gb_s"] = round(bw_copy / 1e9, 1)
    DETAIL["triad_gb_s"] = round(bw_triad / 1e9, 1)
    return max(bw_copy, bw_triad)


# --- matrix builders ---------------------------------------------------------

def banded_csr(n_rows, offsets, dtype=np.float32, seed=0):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n_rows - abs(o)).astype(dtype) for o in offsets]
    return sp.diags(diags, offsets, shape=(n_rows, n_rows), format="csr").astype(dtype)


def banded_dia_device(n, offsets, seed=0):
    """A random banded DIA built ON DEVICE by one jitted program (no host
    copy of an 84M-value matrix)."""
    from sparsemat_tpu.formats.dia import DIA

    @functools.partial(jax.jit, static_argnames=("nn",))
    def build(key, nn):
        idx = jnp.arange(nn, dtype=jnp.int32)
        rows = []
        for k, off in enumerate(offsets):
            vals = jax.random.normal(jax.random.fold_in(key, k), (nn,), jnp.float32)
            valid = (idx + off >= 0) & (idx + off < nn)
            rows.append(jnp.where(valid, vals, 0))
        return jnp.stack(rows)

    data = build(jax.random.PRNGKey(seed), n)
    return DIA(data=data, offsets=tuple(offsets), shape=(n, n))


def poisson2d_dia_device(n, dtype=jnp.float32):
    """2D 5-point Poisson (n² rows) as a device-built DIA."""
    from sparsemat_tpu.formats.dia import DIA

    @functools.partial(jax.jit, static_argnames=("nn",))
    def build(nn):
        m = nn * nn
        i = jnp.arange(m, dtype=jnp.int32)
        return jnp.stack([
            jnp.where(i >= nn, -1.0, 0.0),            # off = -n
            jnp.where(i % nn != 0, -1.0, 0.0),        # off = -1
            jnp.full((m,), 4.0),
            jnp.where(i % nn != nn - 1, -1.0, 0.0),   # off = +1
            jnp.where(i < m - nn, -1.0, 0.0),         # off = +n
        ]).astype(dtype)

    m = n * n
    return DIA(data=build(n), offsets=(-n, -1, 0, 1, n), shape=(m, m))


def check_dia_sampled(dia, x, y, n_check=2048):
    """Verify a device SpMV result on a sampled row window (host pulls only
    the window, not the whole matrix); returns max abs err / max |ref|."""
    n = dia.shape[0]
    lo = n // 3
    hi = lo + n_check
    max_off = max(abs(o) for o in dia.offsets)
    xs = np.asarray(x[max(0, lo - max_off): min(n, hi + max_off)])
    x0 = max(0, lo - max_off)
    ys = np.asarray(y[lo:hi])
    ref = np.zeros(hi - lo, np.float64)
    for d, off in enumerate(dia.offsets):
        dd = np.asarray(dia.data[d, lo:hi], np.float64)
        src = np.arange(lo, hi) + off
        ok = (src >= 0) & (src < n)
        ref[ok] += dd[ok] * xs[src[ok] - x0]
    return np.abs(ys - ref).max() / max(np.abs(ref).max(), 1e-30)


# --- per-config benches ------------------------------------------------------

def bench_spmv_variants(name, mat_scipy, variants):
    """Time each frozen variant of ``mat_scipy`` (every variant runs its
    format's XLA path); report Gnnz/s, the host freeze seconds and, for HBM
    cells, the share of the published HBM peak of the layout's traffic
    bytes.  Returns {variant: gnnz_per_s}."""
    import sparsemat_tpu as smt
    from sparsemat_tpu.utils import time_chained_op

    nnz = mat_scipy.nnz
    n = mat_scipy.shape[1]
    x = jnp.asarray(np.random.default_rng(1).standard_normal(n).astype(np.float32))
    csr = smt.CSR.from_scipy(mat_scipy)
    y_ref = mat_scipy @ np.asarray(x)
    nrm = max(np.abs(y_ref).max(), 1e-30)

    results = {}
    for vname, make in variants.items():
        try:
            t0 = time.perf_counter()
            mat = make(csr)
            t_freeze = time.perf_counter() - t0
            y = jax.jit(smt.spmv)(mat, x)
            err = np.abs(np.asarray(y) - y_ref).max() / nrm
            if err > 1e-4:
                log(f"  {name}/{vname}: WRONG RESULT (rel err {err:.1e}) — skipped")
                continue
            dt = time_chained_op(lambda v, m: smt.spmv(m, v), x, captures=(mat,))
            sol_bytes = mat.spmv_traffic_bytes()
            frac = hbm_share(f"{name}/{vname}", sol_bytes, dt)
            results[vname] = nnz / dt
            share = ("L2 cell" if frac is None
                     else f"{100*frac:5.1f}% of HBM peak")
            log(f"  {name}/{vname:12s}: {dt*1e6:9.1f} us/spmv "
                f"{nnz/dt/1e9:7.3f} Gnnz/s  {share} "
                f"({sol_bytes/1e6:.1f} MB/spmv, freeze {t_freeze:.2f} s, "
                f"{type(mat).__name__}, err {err:.1e})")
            DETAIL.setdefault("spmv_gnnz_per_s", {})[f"{name}/{vname}"] = round(
                nnz / dt / 1e9, 3)
            DETAIL.setdefault("freeze_s", {})[f"{name}/{vname}"] = round(
                t_freeze, 3)
        except BenchTimeout:
            raise
        except Exception as e:  # one layout failing must not hide the rest
            log(f"  {name}/{vname}: failed — {str(e)[:140]}")
            DETAIL.setdefault("failed_variants", []).append(f"{name}/{vname}")
    return results


#: quantized CG iteration counts — each distinct count is a separate compile
_CG_ITER_CHOICES = np.array([300, 1000, 3000, 10000])


def bench_cg(n=512):
    """f32 CG iterations/s on 2D Poisson (tol=0: every iteration runs);
    the iteration count is scaled so the timed window is ~1 s."""
    from sparsemat_tpu import solvers

    m = n * n
    A = poisson2d_dia_device(n)
    b = jnp.ones((m,), jnp.float32)

    def make(iters):
        return jax.jit(lambda mat, rhs: solvers.cg(mat, rhs, tol=0.0,
                                                   maxiter=iters))

    iters = int(_CG_ITER_CHOICES[0])
    f = make(iters)
    x, info = f(A, b)
    assert int(info.iterations) == iters, "CG exited early"
    t0 = time.perf_counter()
    f(A, b)[0].block_until_ready()
    est = max(time.perf_counter() - t0, 1e-9) / iters
    want = int(np.clip(1.0 / est, _CG_ITER_CHOICES[0], _CG_ITER_CHOICES[-1]))
    iters = int(_CG_ITER_CHOICES[np.searchsorted(_CG_ITER_CHOICES, want)])
    if iters != _CG_ITER_CHOICES[0]:
        f = make(iters)
        f(A, b)[0].block_until_ready()
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        x, info = f(A, b)
        x.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / iters)
    ips = 1.0 / best
    # per-iteration traffic LOWER bound under full fusion: the matrix
    # stream + one vector read + one vector write
    a_bytes = A.spmv_traffic_bytes() - 2 * m * 4   # matrix arrays only
    frac = hbm_share(f"cg_poisson_{m}", a_bytes + 2 * m * 4, best)
    share = "L2 cell" if frac is None else f"{100*frac:.1f}% of HBM peak"
    log(f"  CG Poisson {m:,} rows f32: {ips:,.0f} iters/s "
        f"({best*1e6:.0f} us/iter over {iters} iters, {share})")
    return ips, frac


# --- main --------------------------------------------------------------------

def device_setup():
    """Name the device and load its published peaks.  A device missing from
    the peaks table (a CPU backend included) stops the run before any
    result is printed."""
    from sparsemat_tpu.utils import (card_name_and_power_limit, device_peaks,
                                     enable_compile_cache)

    enable_compile_cache()
    d0 = jax.devices()[0]
    PEAK.update(device_peaks(d0))
    DETAIL["platform"] = d0.platform
    DETAIL["device_kind"] = d0.device_kind
    DETAIL["device_count"] = len(jax.devices())
    DETAIL["card"] = card_name_and_power_limit()
    DETAIL["hbm_peak_gb_s"] = round(PEAK["hbm_bw"] / 1e9, 1)
    log(f"devices: {jax.devices()}  card: {DETAIL['card']}  "
        f"budget: {BUDGET:.0f}s")


def main():
    import scipy.sparse as sp

    import sparsemat_tpu as smt
    from sparsemat_tpu import io as smtio
    from sparsemat_tpu import matgen
    from sparsemat_tpu.utils import time_chained_op

    COPY["bw"] = measure_copy_bw()

    # ---- config 2 (HEADLINE, first): 2^24-row banded DIA, HBM-bound --------
    def config_headline():
        n_big = 1 << 24
        big = banded_dia_device(n_big, [-4096, -1, 0, 1, 4096]).scale(5e-4)
        x_big = jax.random.normal(jax.random.PRNGKey(99), (n_big,), jnp.float32)
        y_big = jax.jit(smt.spmv)(big, x_big)
        err = check_dia_sampled(big, x_big, y_big)
        if err > 1e-4:
            log(f"  banded_16M: WRONG RESULT rel err {err:.1e}")
            return
        dt = time_chained_op(lambda v, m: smt.spmv(m, v), x_big,
                             captures=(big,), inner=256)
        big_nnz_s = 5 * n_big / dt
        frac = hbm_share("banded_16M/dia", big.spmv_traffic_bytes(), dt)
        log(f"  banded_16M/dia (XLA shifted slices): {dt*1e6:.1f} us/spmv  "
            f"{big_nnz_s/1e9:.3f} Gnnz/s → {100*frac:.1f}% of HBM peak "
            f"(sampled check err {err:.1e})")
        DETAIL["spmv_banded_16M_gnnz_per_s"] = round(big_nnz_s / 1e9, 3)
        RESULT["value"] = round(float(frac), 4)
        RESULT["vs_baseline"] = round(float(frac) / 0.70, 4)

    run_config("headline_banded_16M", 60, config_headline, cap=180)

    # ---- config 1: banded 1e4 rows (L2-resident latency regime) ------------
    def config_small_banded():
        small = banded_csr(10_000, [-100, -1, 0, 1, 100]) * 5e-4
        res1 = bench_spmv_variants(
            "banded_1e4", small,
            {"csr_stream": lambda c: c, "ell": lambda c: c.to_ell(),
             "dia": lambda c: c.to_dia()})
        if res1:
            DETAIL["spmv_banded_1e4_gnnz_per_s"] = round(
                max(res1.values()) / 1e9, 3)
        # the solver-loop regime: k SpMVs chained in one compiled loop
        dia_s = smt.CSR.from_scipy(small).to_dia()
        xs = jnp.asarray(np.random.default_rng(1)
                         .standard_normal(10_000).astype(np.float32))
        k = 1024
        dt_chain = time_chained_op(lambda v, m: smt.spmv_chain(m, v, k), xs,
                                   captures=(dia_s,), max_inner=256)
        per_spmv = dt_chain / k
        log(f"  banded_1e4/chain(k={k}): {per_spmv*1e6:.3f} us/spmv "
            f"{small.nnz/per_spmv/1e9:.1f} Gnnz/s (L2 cell)")
        DETAIL["spmv_banded_1e4_chained_us"] = round(per_spmv * 1e6, 3)

    run_config("banded_1e4", 45, config_small_banded, cap=150)

    # ---- config 5: assembly inserts through the C++ hash store (host) ------
    def config_assembly():
        n_ins = 2_000_000
        rng2 = np.random.default_rng(5)
        ir = rng2.integers(0, 100_000, n_ins)
        ic = rng2.integers(0, 100_000, n_ins)
        iv = rng2.standard_normal(n_ins)
        t_ins = np.inf
        for _ in range(3):
            builder = smt.SparseBuilder()
            t0 = time.perf_counter()
            builder.add_batch(ir, ic, iv)
            t_ins = min(t_ins, time.perf_counter() - t0)
        t0 = time.perf_counter()
        frozen = builder.to_csr()
        t_freeze = time.perf_counter() - t0
        xa = rng2.standard_normal(frozen.shape[1]).astype(np.float32)
        ya = np.asarray(smt.spmv(frozen, jnp.asarray(xa)))
        ref_m = sp.coo_matrix((iv, (ir, ic))).tocsr()
        err_a = np.abs(ya[: ref_m.shape[0]]
                       - (ref_m @ xa[: ref_m.shape[1]]).astype(np.float32)).max()
        ins_per_s = n_ins / t_ins
        log(f"  assembly (host): {ins_per_s/1e6:.1f}M inserts/s (C++ store, "
            f"best of 3), freeze {t_freeze*1e3:.0f} ms, spmv err {err_a:.1e}")
        DETAIL["assembly_minserts_per_s"] = round(ins_per_s / 1e6, 1)

    run_config("assembly", 25, config_assembly, cap=90)

    # ---- config 4a: scircuit-class (power-law global scatter) ---------------
    # every layout that freezes this matrix (ELL pads 695x, StripELL's
    # span check refuses it, SlabPack's freeze exceeds 24x nnz)
    circ = (matgen.circuit_scatter() * np.float32(2e-2)).astype(np.float32).tocsr()

    def config_scircuit_spmv():
        res = bench_spmv_variants(
            "scircuit_171k", circ,
            {"csr_stream": lambda c: c,
             "sell": lambda c: smt.SELL.from_csr(c, slice_height=8),
             "gell": lambda c: c.to_gell(), "route": lambda c: c.to_route(),
             "auto": smt.auto_format})
        if res:
            DETAIL["spmv_scircuit_gnnz_per_s"] = round(max(res.values()) / 1e9, 3)

    run_config("scircuit_spmv", 100, config_scircuit_spmv, cap=300)

    # the same generator at 4M rows: a scattered matrix past the L2
    def config_scatter_4m():
        big = (matgen.circuit_scatter(n=4_000_000) * np.float32(2e-2)).astype(
            np.float32).tocsr()
        bench_spmv_variants(
            "scatter_4M", big,
            {"csr_stream": lambda c: c,
             "sell": lambda c: smt.SELL.from_csr(c, slice_height=8),
             "gell": lambda c: c.to_gell(), "auto": smt.auto_format})

    run_config("scatter_4M_spmv", 100, config_scatter_4m, cap=300)

    # FEM matrices whose ELL padding is under 2x: ELL against GELL
    def config_fem_low_padding():
        for n_nodes, deg in ((150_000, 16), (100_000, 32)):
            fm = matgen.fem_block_band(n_nodes=n_nodes, mean_deg=deg)
            fm = (fm * np.float32(2e-2)).astype(np.float32).tocsr()
            rn = np.diff(fm.indptr)
            name = f"fem_{fm.shape[0] // 1000}k"
            DETAIL.setdefault("ell_padding", {})[name] = round(
                float(rn.max() * fm.shape[0] / fm.nnz), 3)
            log(f"  {name}: {fm.nnz:,} nnz, ELL padding "
                f"{DETAIL['ell_padding'][name]}x")
            bench_spmv_variants(
                name, fm, {"csr_stream": lambda c: c, "ell": lambda c: c.to_ell(),
                           "gell": lambda c: c.to_gell(),
                           "auto": smt.auto_format})

    run_config("fem_low_padding_spmv", 120, config_fem_low_padding, cap=360)

    rngp = np.random.default_rng(5)

    def spgemm_one(nm, spm):
        A = smt.CSR.from_scipy(spm)
        times = []
        for _ in range(2):   # the first run includes compilation
            t0 = time.perf_counter()
            C = smt.spgemm(A, A)
            C.data.block_until_ready()
            times.append(time.perf_counter() - t0)
        v = rngp.standard_normal(spm.shape[1]).astype(np.float32)
        cv = np.asarray(jax.jit(smt.spmv)(C, jnp.asarray(v)))
        rv = spm @ (spm @ v)
        errp = np.abs(cv - rv).max() / max(np.abs(rv).max(), 1e-30)
        nnz_out = int(C.nse)
        log(f"  spgemm {nm} A@A: warm {times[1]:.2f}s (cold {times[0]:.1f}s) → "
            f"{nnz_out/times[1]/1e6:.2f} M out-nnz/s (out nnz {nnz_out:,}, "
            f"probe err {errp:.1e})")
        DETAIL[f"spgemm_{nm}_mnnz_per_s"] = round(nnz_out / times[1] / 1e6, 2)

    run_config("spgemm_scircuit", 60,
               lambda: spgemm_one("scircuit", circ), cap=180)

    # ---- config 3: CG f32 ----------------------------------------------------
    def config_cg_small():
        ips, _ = bench_cg(n=512)                  # 262k rows: L2 cell
        DETAIL["cg_poisson_262k_iters_per_s"] = round(ips, 1)

    def config_cg_big():
        ips, frac = bench_cg(n=2048)              # 4.2M rows: HBM cell
        DETAIL["cg_poisson_4M_iters_per_s"] = round(ips, 1)

    run_config("cg_f32_262k", 40, config_cg_small, cap=120)
    run_config("cg_f32_4M", 50, config_cg_big, cap=150)

    # ---- config 3b: f64 CG to 1e-8 on 1024² Poisson, native f64 ------------
    def config_cg_f64():
        from sparsemat_tpu import solvers

        n = 1024
        m = n * n
        with jax.enable_x64(True):
            A64 = poisson2d_dia_device(n, jnp.float64)
            # unit-norm rhs: absolute == relative residual, and the 1e-8
            # target sits above the f64 SpMV rounding floor
            b = jnp.full((m,), 1.0 / np.sqrt(m), jnp.float64)
            f = jax.jit(lambda mat, rhs: solvers.cg(mat, rhs, tol=1e-8,
                                                    maxiter=20_000))
            f(A64, b)[0].block_until_ready()
            t0 = time.perf_counter()
            x, info = f(A64, b)
            x.block_until_ready()
            wall = time.perf_counter() - t0
            its = int(info.iterations)
            log(f"  f64 CG 1024² Poisson: {its} iters to "
                f"{float(info.residual_norm):.2e} in {wall:.2f}s "
                f"({its/wall:,.0f} iters/s)")
            DETAIL["f64_cg_1M_iters_per_s"] = round(its / wall, 1)
            DETAIL["f64_cg_1M_time_to_1e-8_s"] = round(wall, 3)
            A32 = poisson2d_dia_device(n)
            solvers.refine(A64, b, A_low=A32, tol=1e-8, inner_rtol=1e-2,
                           inner_maxiter=6000, max_outer=60)   # compile
            t0 = time.perf_counter()
            x, rinfo = solvers.refine(A64, b, A_low=A32, tol=1e-8,
                                      inner_rtol=1e-2, inner_maxiter=6000,
                                      max_outer=60)
            wall = time.perf_counter() - t0
            res = float(rinfo.residual_norm)
        log(f"  f64 refine (f32 inner CG): residual {res:.2e} in {wall:.2f}s "
            f"({int(rinfo.iterations)} inner iters, "
            f"converged={bool(rinfo.converged)})")
        DETAIL["f64_refine_residual"] = res
        DETAIL["f64_refine_wall_s"] = round(wall, 3)
        DETAIL["f64_refine_converged"] = bool(rinfo.converged)

    run_config("cg_f64_1M", 40, config_cg_f64, cap=180)

    # ---- config 4b: pwtk-class FEM surrogate --------------------------------
    fem_state = {}

    def config_fem_io():
        # written to a real .mtx file and read back through io.load_mtx
        fem = (matgen.fem_block_band() * np.float32(2e-2)).astype(np.float32).tocsr()
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "fem_block_band.mtx")
            t0 = time.perf_counter()
            smtio.save_mtx(smt.CSR.from_scipy(fem), p)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            fem_csr = smtio.load_mtx(p, dtype=np.float32)
            t_load = time.perf_counter() - t0
            sz = os.path.getsize(p)
        log(f"  fem_217k (host I/O): {fem.shape[0]:,} rows, {fem.nnz:,} nnz — "
            f".mtx {sz/1e6:.0f} MB, save {fem.nnz/t_save/1e6:.1f} M/s, "
            f"load {fem.nnz/t_load/1e6:.1f} M/s (parser={smtio.last_mtx_parser})")
        DETAIL["save_mtx_mentries_per_s"] = round(fem.nnz / t_save / 1e6, 1)
        DETAIL["load_mtx_mentries_per_s"] = round(fem.nnz / t_load / 1e6, 1)
        DETAIL["mtx_parser"] = smtio.last_mtx_parser
        fem_state["scipy"] = fem
        fem_state["csr"] = fem_csr

    run_config("fem_mtx_roundtrip", 50, config_fem_io, cap=150)
    if "scipy" not in fem_state:
        fem_state["scipy"] = (matgen.fem_block_band()
                              * np.float32(2e-2)).astype(np.float32).tocsr()
        fem_state["csr"] = smt.CSR.from_scipy(fem_state["scipy"])

    run_config("spgemm_fem", 90, lambda: spgemm_one("fem_217k",
                                                    fem_state["scipy"]),
               cap=340)

    # ---- config 4c: fem SpMV / SpMM -----------------------------------------
    def config_fem_spmv():
        res = bench_spmv_variants(
            "fem_217k", fem_state["scipy"],
            {"csr_stream": lambda c: c, "ell": lambda c: c.to_ell(),
             "sell": lambda c: smt.SELL.from_csr(c, slice_height=8),
             "gell": lambda c: c.to_gell(), "strip": lambda c: c.to_strip(),
             "slab_pack": lambda c: c.to_slab_pack(),
             "route": lambda c: c.to_route(), "auto": smt.auto_format})
        if res:
            DETAIL["spmv_fem_217k_gnnz_per_s"] = round(max(res.values()) / 1e9, 3)

    run_config("fem_spmv", 120, config_fem_spmv, cap=360)

    def config_fem_spmm():
        # BSR with (512×128) blocks frozen on device (one scatter builds the
        # blocks from the resident CSR); f32 at Precision.HIGHEST
        fem, fem_csr = fem_state["scipy"], fem_state["csr"]
        m_rhs = 128
        B = jnp.asarray(np.random.default_rng(3).standard_normal(
            (fem.shape[1], m_rhs)).astype(np.float32) * 0.01)
        refY = fem[:256] @ np.asarray(B, np.float64)
        mm = smt.BSR.from_csr_device(fem_csr, br=512, bc=128)
        Y = jax.jit(smt.spmm)(mm, B)
        errY = np.abs(np.asarray(Y[:256]) - refY).max() / np.abs(refY).max()
        if errY > 1e-5:
            log(f"  fem_217k/spmm/bsr: WRONG (err {errY:.1e})")
            return
        dtY = time_chained_op(lambda b2, m2: smt.spmm(m2, b2), B, (mm,),
                              max_inner=64)
        tf = 2 * fem.nnz * m_rhs / dtY / 1e12
        log(f"  fem_217k/spmm(m=128)/bsr: {dtY*1e3:.2f} ms  "
            f"{fem.nnz*m_rhs/dtY/1e9:.1f} Gnnz·col/s  {tf:.3f} Tflop/s "
            f"(err {errY:.1e})")
        DETAIL["spmm_fem_217k_bsr_tflops"] = round(tf, 3)

    run_config("fem_spmm", 60, config_fem_spmm, cap=240)


if __name__ == "__main__":
    device_setup()
    signal.signal(signal.SIGTERM, _sig_handler)
    signal.signal(signal.SIGALRM, _sig_handler)
    atexit.register(emit_final)
    try:
        main()
    except BenchTimeout as e:
        log(f"bench stopped by signal: {e}")
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        emit_final()
