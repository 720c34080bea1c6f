#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
nonzero before the last line is printed):

0. build the CUDA kernels of ``arnoldi_tpu_torch/csrc`` with nvcc (one
   process per source, all started together);
1. hold each kernel against its plain PyTorch version at the main path's
   shapes, in float32 and float64, and time both with CUDA events: the
   single-column kernels, the b = 8 column forms of DIA, ELL and both BSR
   kernels, and BSR-8 on a matrix whose n is not a multiple of 8;
2. solve A: ``partial_schur`` on ``laplace_2d(724)`` (n = 524,176, DIA
   kernel + fused CGS2), LM, k = 5, m = 80, float64, tol 1e-8, checked
   against the analytic spectrum;
3. solve B: ``partial_schur`` on the scattered 2^20-row matrix (ELL kernel
   + fused CGS2), LR, k = 5, m = 40, float64, tol 1e-8, checked against
   ARPACK (``scipy.sparse.linalg.eigs``);
4. solve C: the same matrix as ``format=("bsr", (8, 8))`` (BSR gather
   kernel), scalar, same settings, checked against solve B's ARPACK values;
5. solve D: ``random_scattered(2^20, 24, seed=2, bandwidth=1024, block=8)``
   as BSR-8 (its window fits shared memory: BSR window kernel, b-column
   form), ``block_size=8``, LR, k = 5, m = 40, checked against ARPACK;
6. solve E: ``laplace_2d(724)``, ``block_size=8`` (DIA b-column kernel),
   LM, k = 5, m = 80, p = 40, checked against the analytic spectrum;
7. solve F: the scattered 2^20 matrix by default routing (ELL b-column
   kernel), ``block_size=8``, LR, k = 5, m = 40, checked against solve B's
   ARPACK values;
8. solve G: the scattered 2^20 matrix as BSR-8, ``block_size=8`` (BSR
   gather kernel, b-column form), checked the same way;
9. solve H: the bandwidth-1024 matrix as BSR-8, scalar (BSR window kernel),
   checked against solve D's ARPACK values.

All solves run in float64 to tol 1e-8 and must give a Schur residual
``||AQ - QT|| / max|lambda| <= 1e-7`` and eigenvalues within 1e-9 of the
reference.  The kernels' launch counters are zeroed just before phase 2
and read after phase 9; every kernel must have launched, and each solve
must have launched the kernels of its operator.  The line before the last
is a JSON object with each kernel's route, source, launches, error and
times; the last line is ``{"ok": true, "device": {...}}``.  Needs no network
and imports nothing of JAX.
"""

import json
import os
import subprocess
import time

F64_LIMIT = 1e-12   # normwise relative error, float64
F32_LIMIT = 1e-5    # normwise relative error, float32


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want):
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    denom = torch.linalg.vector_norm(want).item()
    diff = torch.linalg.vector_norm(got - want).item()
    return diff / (denom if denom else 1.0), (got - want).abs().max().item()


class KernelRecord:
    """Errors and times of one kernel over the phase-1 cases."""

    def __init__(self):
        self.max_abs_err = 0.0      # float64 cases (the main path's dtype)
        self.ms = None
        self.plain_ms = None

    def check(self, label, dtype, got, want):
        import torch

        rel, abs_err = rel_err(got, want)
        limit = F64_LIMIT if dtype == torch.float64 else F32_LIMIT
        print(f"  {label:<44} {str(dtype):<14} rel {rel:.3e}  "
              f"max_abs {abs_err:.3e}  (limit {limit:g})")
        if not rel <= limit:
            fail(f"{label} {dtype}: relative error {rel:.3e} > {limit:g}")
        if dtype == torch.float64:
            self.max_abs_err = max(self.max_abs_err, abs_err)


def phase_kernels(mats):
    """Phase 1: each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch.linop import BandedOperator, EllOperator, cast_operator
    from arnoldi_tpu_torch.ops import kernels, ortho
    from arnoldi_tpu_torch.ops.kernels import ortho_fused, spmv_banded, spmv_ell

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {name: KernelRecord() for name in kernels.KERNELS}

    # The tolerances: each kernel sums the same products as its plain
    # version in another order (per-thread, shuffle tree, then split-K
    # partials), so they differ by rounding alone: a few ulps of the
    # operand dtype times the conditioning of the sums.
    dia64 = BandedOperator.from_scipy(mats["laplace"], device=dev)
    for dtype in (torch.float64, torch.float32):
        op = cast_operator(dia64, dtype)
        x = torch.randn(op.shape[0], generator=gen, device=dev, dtype=dtype)
        rec["spmv_dia"].check("DIA laplace_2d(724) (5, 524176)", dtype,
                              spmv_banded.banded_matvec(op.bands, x, op.offsets),
                              spmv_banded.banded_matvec_plain(op.bands, x, op.offsets))
        if dtype == torch.float64:
            rec["spmv_dia"].ms = cuda_ms(
                lambda: spmv_banded.banded_matvec(op.bands, x, op.offsets))
            rec["spmv_dia"].plain_ms = cuda_ms(
                lambda: spmv_banded.banded_matvec_plain(op.bands, x, op.offsets))

    for label, A in (("scattered 2^20", mats["scattered"]),
                     ("mark(1000)", mats["mark"]),
                     ("rectangular", mats["rect"])):
        ell64 = EllOperator.from_scipy(A, device=dev)
        for dtype in (torch.float64, torch.float32):
            op = cast_operator(ell64, dtype)
            x = torch.randn(op.shape[1], generator=gen, device=dev, dtype=dtype)
            shape = f"({op.data.shape[0]}, L={op.data.shape[1]}) x {op.shape[1]}"
            rec["spmv_ell"].check(f"ELL {label} {shape}", dtype,
                                  spmv_ell.ell_matvec(op.data, op.cols, x),
                                  spmv_ell.ell_matvec_plain(op.data, op.cols, x))
            if dtype == torch.float64 and label == "scattered 2^20":
                rec["spmv_ell"].ms = cuda_ms(
                    lambda: spmv_ell.ell_matvec(op.data, op.cols, x))
                rec["spmv_ell"].plain_ms = cuda_ms(
                    lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, x))
        del ell64, op

    n, mp1 = mats["laplace"].shape[0], 81
    for dtype in (torch.float64, torch.float32):
        Vt = torch.randn(mp1, n, generator=gen, device=dev, dtype=dtype) / np.sqrt(n)
        w = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        for na in (0, 1, 40, 80):
            # Stale rows past n_active hold NaN: neither version may read them.
            Vs = Vt.clone()
            Vs[na:] = float("nan")
            c = ortho_fused.masked_project(Vs, w, na)
            c_plain = ortho_fused.masked_project_plain(Vs, w, na)
            rec["masked_project"].check(f"masked_project Vt (81, {n}) n_active={na}",
                                        dtype, c, c_plain)
            if not bool((c[na:] == 0).all()):
                fail("masked_project: nonzero coefficient past n_active")
            w2, ns = ortho_fused.project_update_norm(Vs, w, c_plain, na)
            w2p, nsp = ortho_fused.project_update_norm_plain(Vs, w, c_plain, na)
            rec["project_update_norm"].check(
                f"project_update_norm w' n_active={na}", dtype, w2, w2p)
            rec["project_update_norm"].check(
                f"project_update_norm ||w'||^2 n_active={na}", dtype,
                ns.reshape(1), nsp.reshape(1))
            if dtype == torch.float64 and na == 80:
                rec["masked_project"].ms = cuda_ms(
                    lambda: ortho_fused.masked_project(Vs, w, na))
                rec["masked_project"].plain_ms = cuda_ms(
                    lambda: ortho_fused.masked_project_plain(Vs, w, na))
                rec["project_update_norm"].ms = cuda_ms(
                    lambda: ortho_fused.project_update_norm(Vs, w, c_plain, na))
                rec["project_update_norm"].plain_ms = cuda_ms(
                    lambda: ortho_fused.project_update_norm_plain(Vs, w, c_plain, na))
        if dtype == torch.float64:
            # The default ortho, cgs_dgks, on a w mostly inside the span, so
            # that its DGKS second pass runs: the CUDA composition against
            # the same function on CPU copies (the plain versions).
            coef = torch.randn(na, generator=gen, device=dev, dtype=dtype)
            w_span = 0.9 * (coef @ Vt[:na]) + 0.01 * w
            got = ortho.cgs_dgks(Vs, w_span, na)
            want = ortho.cgs_dgks(Vs.cpu(), w_span.cpu(), na)
            check = KernelRecord()
            check.check(f"cgs_dgks h, n_active={na}", dtype, got[0], want[0])
            check.check(f"cgs_dgks w, n_active={na}", dtype, got[1], want[1])
            if bool(got[3]) != bool(want[3]):
                fail("cgs_dgks: breakdown flags differ")
        del Vt, Vs
    sync()
    phase_kernels_cols_and_bsr(mats, rec, gen)
    sync()
    for name, r in rec.items():
        print(f"  time {name:<22} kernel {r.ms:.4f} ms   plain {r.plain_ms:.4f} ms")
    return rec


B_COLS = 8   # the block driver's b on the main path


def phase_kernels_cols_and_bsr(mats, rec, gen):
    """Phase 1, second part: the b-column forms of DIA and ELL and both BSR
    kernels (one column and b columns) against their plain versions."""
    import torch

    from arnoldi_tpu_torch.linop import (BandedOperator, BsrOperator,
                                         EllOperator, cast_operator)
    from arnoldi_tpu_torch.ops.kernels import spmv_banded, spmv_bsr, spmv_ell

    dev = torch.device("cuda")

    def case(name, label, dtype, kernel, plain, timed):
        r = rec[name]
        r.check(label, dtype, kernel(), plain())
        if timed and dtype == torch.float64:
            r.ms = cuda_ms(kernel)
            r.plain_ms = cuda_ms(plain)

    # The tolerances: as above, each kernel sums the same products as its
    # plain version in another order (einsum or gather-then-sum there).
    dia64 = BandedOperator.from_scipy(mats["laplace"], device=dev)
    for dtype in (torch.float64, torch.float32):
        op = cast_operator(dia64, dtype)
        X = torch.randn(B_COLS, op.shape[0], generator=gen, device=dev, dtype=dtype)
        case("spmv_dia_cols", f"DIA laplace_2d(724) b={B_COLS}", dtype,
             lambda: spmv_banded.banded_matmat(op.bands, X, op.offsets),
             lambda: spmv_banded.banded_matvec_plain(op.bands, X, op.offsets),
             timed=True)
        if not torch.equal(spmv_banded.banded_matmat(op.bands, X, op.offsets)[3],
                           spmv_banded.banded_matvec(op.bands, X[3], op.offsets)):
            fail("spmv_dia_cols: a column differs from the single-column kernel")
    del dia64, op, X

    ell64 = EllOperator.from_scipy(mats["scattered"], device=dev)
    for dtype in (torch.float64, torch.float32):
        op = cast_operator(ell64, dtype)
        X = torch.randn(B_COLS, op.shape[1], generator=gen, device=dev, dtype=dtype)
        case("spmv_ell_cols", f"ELL scattered 2^20 b={B_COLS}", dtype,
             lambda: spmv_ell.ell_matmat(op.data, op.cols, X),
             lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, X),
             timed=True)
        if not torch.equal(spmv_ell.ell_matmat(op.data, op.cols, X)[5],
                           spmv_ell.ell_matvec(op.data, op.cols, X[5])):
            fail("spmv_ell_cols: a column differs from the single-column kernel")
    del ell64, op, X

    for label, key, timed in (("scattered 2^20", "scattered", ("spmv_bsr", "spmv_bsr_cols")),
                              ("bandwidth-1024", "window", ("spmv_bsr_window",
                                                            "spmv_bsr_window_cols")),
                              ("mark(1000) n=500500", "mark", ())):
        bsr64 = BsrOperator.from_scipy(mats[key], device=dev)
        print(f"  BSR-8 {label}: blocks {tuple(bsr64.blocks.shape)}, window "
              f"{bsr64.window.width} block-columns "
              f"({bsr64.window.width * 64} B a float64 column), uses the "
              f"{'window' if bsr64.uses_window else 'gather'} kernel")
        for dtype in (torch.float64, torch.float32):
            op = cast_operator(bsr64, dtype)
            x = torch.randn(op.n_cols, generator=gen, device=dev, dtype=dtype)
            X = torch.randn(B_COLS, op.n_cols, generator=gen, device=dev, dtype=dtype)
            blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
            case("spmv_bsr", f"BSR gather {label}", dtype,
                 lambda: spmv_bsr.bsr_matvec(blk, ids, x, nr),
                 lambda: spmv_bsr.bsr_matvec_plain(blk, ids, x, nr),
                 timed="spmv_bsr" in timed)
            case("spmv_bsr_cols", f"BSR gather {label} b={B_COLS}", dtype,
                 lambda: spmv_bsr.bsr_matmat(blk, ids, X, nr),
                 lambda: spmv_bsr.bsr_matvec_plain(blk, ids, X, nr),
                 timed="spmv_bsr_cols" in timed)
            if label == "scattered 2^20":
                continue   # its window is wider than shared memory
            case("spmv_bsr_window", f"BSR window {label}", dtype,
                 lambda: spmv_bsr.bsr_window_matvec(blk, win, x, nr),
                 lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, x, nr),
                 timed="spmv_bsr_window" in timed)
            case("spmv_bsr_window_cols", f"BSR window {label} b={B_COLS}", dtype,
                 lambda: spmv_bsr.bsr_window_matmat(blk, win, X, nr),
                 lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr),
                 timed="spmv_bsr_window_cols" in timed)
            # The two kernels sum the same products in the same order.
            if not torch.equal(spmv_bsr.bsr_window_matmat(blk, win, X, nr),
                               spmv_bsr.bsr_matmat(blk, ids, X, nr)):
                fail(f"BSR {label}: window and gather kernels differ")
            if timed and dtype == torch.float64:
                print(f"  BSR {label}, same matrix: gather "
                      f"{cuda_ms(lambda: spmv_bsr.bsr_matvec(blk, ids, x, nr)):.4f} ms, "
                      f"window {rec['spmv_bsr_window'].ms:.4f} ms; b={B_COLS}: gather "
                      f"{cuda_ms(lambda: spmv_bsr.bsr_matmat(blk, ids, X, nr)):.4f} ms, "
                      f"window {rec['spmv_bsr_window_cols'].ms:.4f} ms")
        del bsr64, op, x, X, blk, ids, win
    sync()
    one = {"spmv_dia_cols": "spmv_dia", "spmv_ell_cols": "spmv_ell",
           "spmv_bsr_cols": "spmv_bsr", "spmv_bsr_window_cols": "spmv_bsr_window"}
    for cols, single in one.items():
        print(f"  {cols}: b={B_COLS} in one call {rec[cols].ms:.4f} ms; "
              f"{B_COLS} single-column calls {B_COLS * rec[single].ms:.4f} ms")


def solve(label, op, nev, which, max_dim, sync_counts, block_size=1, p=None,
          max_restarts=1000):
    """One partial_schur solve on the card; returns (Q, T, hist, wall)."""
    import torch

    from arnoldi_tpu_torch import partial_schur

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q, T, hist = partial_schur(op, nev, max_dim=max_dim, stopping_criterion=1e-8,
                               sort_function=which, dtype=torch.float64,
                               ortho="cgs2", max_restarts=max_restarts,
                               block_size=block_size, p=p)
    sync()
    wall = time.perf_counter() - t0
    mv = hist.total_matvecs
    print(f"  {label}: wall {wall:.4f} s, matvecs {mv}, restarts "
          f"{len(hist.residual_trace)}, {1e3 * wall / mv:.4f} ms/matvec, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches so far: {sync_counts()}")
    print(f"  phases: {json.dumps(hist.phases)}")
    return Q, T, hist, wall


def check_laplace(label, A, Q, T, side):
    """Hold a laplace_2d(side) solve against the analytic spectrum."""
    import numpy as np

    from arnoldi_tpu_torch._host import matrices

    res, lam = schur_residual(A, Q, T)
    exact = np.sort(matrices.laplace_2d_eigen(side))
    idx = np.clip(np.searchsorted(exact, lam.real), 1, exact.size - 1)
    eig_err = np.minimum(np.abs(exact[idx] - lam.real),
                         np.abs(exact[idx - 1] - lam.real))
    top_err = abs(np.abs(lam).max() - np.abs(exact).max())
    print(f"  eigenvalues {np.sort(lam.real)}")
    print(f"  Schur residual / max|lambda| {res.max():.3e} (limit 1e-7); "
          f"eigenvalue error {eig_err.max():.3e} (limit 1e-9); "
          f"max|lambda| error {top_err:.3e} (limit 1e-9)")
    if not (res.max() <= 1e-7 and eig_err.max() <= 1e-9 and top_err <= 1e-9
            and np.all(np.abs(lam.imag) <= 1e-9)):
        fail(f"{label} disagrees with the analytic spectrum")


def arpack(label, A):
    """ARPACK's five largest-real eigenvalues of A on the host."""
    from scipy.sparse.linalg import eigs

    t0 = time.perf_counter()
    ref = eigs(A, 5, which="LR", tol=1e-8, ncv=40, return_eigenvectors=False)
    print(f"  ARPACK on {label} (host, ncv=40) {time.perf_counter() - t0:.2f} s")
    return ref


def check_arpack(label, A, Q, T, ref):
    """Hold a solve against ARPACK's values (Hungarian matching)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    res, lam = schur_residual(A, Q, T)
    cost = np.abs(lam[:, None] - ref[None, :])
    ri, ci = linear_sum_assignment(cost)
    match_err = float(cost[ri, ci].max())
    print(f"  eigenvalues {np.sort_complex(lam)}")
    print(f"  ARPACK: {np.sort_complex(ref)}")
    print(f"  Schur residual / max|lambda| {res.max():.3e} (limit 1e-7); "
          f"matched eigenvalue error {match_err:.3e} (limit 1e-9)")
    if not (res.max() <= 1e-7 and match_err <= 1e-9):
        fail(f"{label} disagrees with ARPACK")


def check_launched(label, before, after, names):
    for name in names:
        if after[name] == before[name]:
            fail(f"{label} did not launch {name}")


def rectangular(n_rows, n_cols, *, max_degree, seed):
    """A random (n_rows, n_cols) CSR matrix with 1..max_degree entries a
    row, so its ELL rows are longer than a warp."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    degrees = rng.integers(1, max_degree + 1, size=n_rows)
    rows = np.repeat(np.arange(n_rows), degrees)
    cols = rng.integers(0, n_cols, size=rows.size)
    vals = rng.standard_normal(rows.size)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))


def schur_residual(A, Q, T):
    import numpy as np

    Qh = Q.double().cpu().numpy()
    Th = T.double().cpu().numpy()
    lam = np.linalg.eigvals(Th)
    res = np.linalg.norm(A @ Qh - Qh @ Th, axis=0) / np.abs(lam).max()
    return res, lam


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.environ.setdefault("ARNOLDI_PHASES", "1")

    from arnoldi_tpu_torch import as_operator
    from arnoldi_tpu_torch._host import matrices, native_dense_tier
    from arnoldi_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    native = native_dense_tier.available()
    print(f"host dense tier: {'native C++' if native else 'SciPy LAPACK'} "
          f"({time.perf_counter() - t0:.2f} s to load or build)")
    print("phase 0: build")
    t0 = time.perf_counter()
    log = kernels.build()
    print(f"  built in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas {line.strip()}")

    t0 = time.perf_counter()
    mats = {
        "laplace": matrices.laplace_2d(724),
        "scattered": matrices.random_scattered(2**20, 24, seed=1,
                                               bandwidth=2**14, block=8),
        "mark": matrices.mark(1000),
        "rect": rectangular(200_000, 300_000, max_degree=60, seed=0),
        "window": matrices.random_scattered(2**20, 24, seed=2,
                                            bandwidth=1024, block=8),
    }
    print(f"  host matrices built in {time.perf_counter() - t0:.2f} s")

    print("phase 1: kernels against their plain PyTorch versions")
    t0 = time.perf_counter()
    rec = phase_kernels(mats)
    print(f"  phase 1 wall {time.perf_counter() - t0:.2f} s")

    def counts():
        sync()
        return kernels.launch_counts()

    print("phase 2: solve A, laplace_2d(724), LM, k=5, m=80, float64, tol 1e-8")
    A = mats["laplace"]
    t0 = time.perf_counter()
    op = as_operator(A, dtype=torch.float64, device="cuda")
    sync()
    print(f"  operator {type(op).__name__} offsets {op.offsets} built in "
          f"{time.perf_counter() - t0:.3f} s")
    kernels.reset_launch_counts()
    before = counts()
    Q, T, hist_a, wall_a = solve("solve A", op, 5, "LM", 80, counts)
    check_launched("solve A", before, counts(),
                   ("spmv_dia", "masked_project", "project_update_norm"))
    check_laplace("solve A", A, Q, T, 724)
    del Q

    print("phase 3: solve B, random_scattered(2^20), LR, k=5, m=40, float64, tol 1e-8")
    A = mats["scattered"]
    t0 = time.perf_counter()
    op = as_operator(A, dtype=torch.float64, device="cuda")
    sync()
    print(f"  operator {type(op).__name__} L={op.data.shape[1]} nnz={op.nnz} "
          f"built in {time.perf_counter() - t0:.3f} s")
    before = counts()
    Q, T, hist_b, wall_b = solve("solve B", op, 5, "LR", 40, counts)
    check_launched("solve B", before, counts(), ("spmv_ell",))
    ref_b = arpack("the scattered 2^20 matrix", A)
    check_arpack("solve B", A, Q, T, ref_b)
    del Q, op

    def bsr(A):
        t0 = time.perf_counter()
        op = as_operator(A, dtype=torch.float64, format=("bsr", (8, 8)),
                         device="cuda")
        sync()
        print(f"  operator BsrOperator blocks {tuple(op.blocks.shape)}, window "
              f"{op.window.width} block-columns -> "
              f"{'window' if op.uses_window else 'gather'} kernel, built in "
              f"{time.perf_counter() - t0:.3f} s")
        return op

    print("phase 4: solve C, the scattered 2^20 matrix as BSR-8, LR, k=5, m=40")
    op = bsr(A)
    if op.uses_window:
        fail("solve C: the scattered matrix's window should exceed the budget")
    before = counts()
    Q, T, hist_c, wall_c = solve("solve C", op, 5, "LR", 40, counts)
    check_launched("solve C", before, counts(), ("spmv_bsr",))
    check_arpack("solve C", A, Q, T, ref_b)
    print(f"  matvecs: solve C (BSR-8) {hist_c.total_matvecs}, solve B (ELL) "
          f"{hist_b.total_matvecs}; wall {wall_c:.4f} s vs {wall_b:.4f} s")
    del Q, op

    print(f"phase 5: solve D, random_scattered(2^20, bandwidth=1024) as BSR-8, "
          f"block_size={B_COLS}, LR, k=5, m=40")
    A_win = mats["window"]
    op = bsr(A_win)
    if not op.uses_window:
        fail("solve D: the bandwidth-1024 matrix's window should fit")
    before = counts()
    Q, T, hist_d, wall_d = solve("solve D", op, 5, "LR", 40, counts,
                                 block_size=B_COLS)
    check_launched("solve D", before, counts(), ("spmv_bsr_window_cols",))
    ref_d = arpack("the bandwidth-1024 matrix", A_win)
    check_arpack("solve D", A_win, Q, T, ref_d)
    del Q, op

    print(f"phase 6: solve E, laplace_2d(724), block_size={B_COLS}, LM, k=5, "
          f"m=80, p=40")
    A = mats["laplace"]
    op = as_operator(A, dtype=torch.float64, device="cuda")
    before = counts()
    # p = m/2 (keep half): the block driver's default p = 16 converges far
    # more slowly on this clustered spectrum (42,128 against 26,720 matvecs
    # at laplace_2d(400) on the CPU), and its restart count grows with n.
    Q, T, hist_e, wall_e = solve("solve E", op, 5, "LM", 80, counts,
                                 block_size=B_COLS, p=40, max_restarts=5000)
    check_launched("solve E", before, counts(), ("spmv_dia_cols",))
    check_laplace("solve E", A, Q, T, 724)
    print(f"  ms/matvec: solve E (block-8) {1e3 * wall_e / hist_e.total_matvecs:.4f}, "
          f"solve A (scalar) {1e3 * wall_a / hist_a.total_matvecs:.4f}")
    del Q, op

    A = mats["scattered"]
    print(f"phase 7: solve F, the scattered 2^20 matrix (ELL), "
          f"block_size={B_COLS}, LR, k=5, m=40")
    op = as_operator(A, dtype=torch.float64, device="cuda")
    before = counts()
    Q, T, hist_f, wall_f = solve("solve F", op, 5, "LR", 40, counts,
                                 block_size=B_COLS)
    check_launched("solve F", before, counts(), ("spmv_ell_cols",))
    check_arpack("solve F", A, Q, T, ref_b)
    del Q, op

    print(f"phase 8: solve G, the scattered 2^20 matrix as BSR-8, "
          f"block_size={B_COLS}, LR, k=5, m=40")
    op = bsr(A)
    before = counts()
    Q, T, hist_g, wall_g = solve("solve G", op, 5, "LR", 40, counts,
                                 block_size=B_COLS)
    check_launched("solve G", before, counts(), ("spmv_bsr_cols",))
    check_arpack("solve G", A, Q, T, ref_b)
    del Q, op

    print("phase 9: solve H, the bandwidth-1024 matrix as BSR-8, scalar, LR, "
          "k=5, m=40")
    op = bsr(A_win)
    before = counts()
    Q, T, hist_h, wall_h = solve("solve H", op, 5, "LR", 40, counts)
    check_launched("solve H", before, counts(), ("spmv_bsr_window",))
    check_arpack("solve H", A_win, Q, T, ref_d)
    del Q, op

    final = counts()
    missing = [k for k, v in final.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    print(f"launches on the main path (phases 2-9): {final}")
    summary = {label: {"matvecs": h.total_matvecs, "restarts": len(h.residual_trace),
                       "wall_s": w, "ms_per_matvec": 1e3 * w / h.total_matvecs}
               for label, h, w in (("A", hist_a, wall_a), ("B", hist_b, wall_b),
                                   ("C", hist_c, wall_c), ("D", hist_d, wall_d),
                                   ("E", hist_e, wall_e), ("F", hist_f, wall_f),
                                   ("G", hist_g, wall_g), ("H", hist_h, wall_h))}
    print(f"solves: {json.dumps(summary)}")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": final[name], "max_abs_err": rec[name].max_abs_err,
         "ms": rec[name].ms, "plain_ms": rec[name].plain_ms}
        for name, (_, source, replaces) in kernels.KERNELS.items()]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
