#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
nonzero before the last line is printed):

0. build the CUDA kernels of ``arnoldi_tpu_torch/csrc`` with nvcc;
1. hold each kernel against its plain PyTorch version at the main path's
   shapes, in float32 and float64, and time both with CUDA events;
2. solve A: ``partial_schur`` on ``laplace_2d(724)`` (n = 524,176, DIA
   kernel + fused CGS2), LM, k = 5, m = 80, float64, tol 1e-8, checked
   against the analytic spectrum;
3. solve B: ``partial_schur`` on the scattered 2^20-row matrix (ELL kernel
   + fused CGS2), LR, k = 5, m = 40, float64, tol 1e-8, checked against
   ARPACK (``scipy.sparse.linalg.eigs``).

The kernels' launch counters are zeroed just before phase 2 and read after
phases 2 and 3; every kernel must have launched.  The line before the last
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
    from arnoldi_tpu_torch.ops import ortho
    from arnoldi_tpu_torch.ops.kernels import ortho_fused, spmv_banded, spmv_ell

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {name: KernelRecord() for name in
           ("spmv_dia", "spmv_ell", "masked_project", "project_update_norm")}

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
    for name, r in rec.items():
        print(f"  time {name:<20} kernel {r.ms:.4f} ms   plain {r.plain_ms:.4f} ms")
    return rec


def solve(label, op, nev, which, max_dim, sync_counts):
    """One partial_schur solve on the card; returns (Q, T, hist)."""
    import torch

    from arnoldi_tpu_torch import partial_schur

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q, T, hist = partial_schur(op, nev, max_dim=max_dim, stopping_criterion=1e-8,
                               sort_function=which, dtype=torch.float64,
                               ortho="cgs2", max_restarts=1000)
    sync()
    wall = time.perf_counter() - t0
    mv = hist.total_matvecs
    print(f"  {label}: wall {wall:.4f} s, matvecs {mv}, restarts "
          f"{len(hist.residual_trace)}, {1e3 * wall / mv:.4f} ms/matvec, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches so far: {sync_counts()}")
    print(f"  phases: {json.dumps(hist.phases)}")
    return Q, T, hist


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

    import numpy as np

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
    Q, T, _ = solve("solve A", op, 5, "LM", 80, counts)
    after_a = counts()
    res, lam = schur_residual(A, Q, T)
    exact = np.sort(matrices.laplace_2d_eigen(724))
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
        fail("solve A disagrees with the analytic spectrum")
    for name in ("spmv_dia", "masked_project", "project_update_norm"):
        if after_a[name] == 0:
            fail(f"solve A did not launch {name}")
    del Q, op

    print("phase 3: solve B, random_scattered(2^20), LR, k=5, m=40, float64, tol 1e-8")
    A = mats["scattered"]
    t0 = time.perf_counter()
    op = as_operator(A, dtype=torch.float64, device="cuda")
    sync()
    print(f"  operator {type(op).__name__} L={op.data.shape[1]} nnz={op.nnz} "
          f"built in {time.perf_counter() - t0:.3f} s")
    before_b = counts()
    Q, T, _ = solve("solve B", op, 5, "LR", 40, counts)
    final = counts()
    if final["spmv_ell"] == before_b["spmv_ell"]:
        fail("solve B did not launch spmv_ell")
    res, lam = schur_residual(A, Q, T)
    from scipy.optimize import linear_sum_assignment
    from scipy.sparse.linalg import eigs

    t0 = time.perf_counter()
    ref = eigs(A, 5, which="LR", tol=1e-8, ncv=40, return_eigenvectors=False)
    arpack_s = time.perf_counter() - t0
    cost = np.abs(lam[:, None] - ref[None, :])
    ri, ci = linear_sum_assignment(cost)
    match_err = float(cost[ri, ci].max())
    print(f"  eigenvalues {np.sort_complex(lam)}")
    print(f"  ARPACK (host, ncv=40) {arpack_s:.2f} s: {np.sort_complex(ref)}")
    print(f"  Schur residual / max|lambda| {res.max():.3e} (limit 1e-7); "
          f"matched eigenvalue error {match_err:.3e} (limit 1e-9)")
    if not (res.max() <= 1e-7 and match_err <= 1e-9):
        fail("solve B disagrees with ARPACK")

    missing = [k for k, v in final.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    print(f"launches on the main path (phases 2-3): {final}")

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
