#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
nonzero before the last line is printed):

0. build the CUDA kernels of ``arnoldi_tpu_torch/csrc`` with nvcc (one
   process per source, all started together);
1. hold each kernel against its plain PyTorch version at the main path's
   shapes, in float32 and float64, and time both with CUDA events (the
   kernel also by the profiler's device time): the
   single-column kernels, the b = 8 column forms of DIA, ELL and both BSR
   kernels, and BSR-8 on a matrix whose n is not a multiple of 8; compute
   each kernel's bound (bytes over 3.35 TB/s or flops over the fp64 rate,
   whichever is larger) and time the one PyTorch call that computes the same
   function (cuSPARSE through ``torch.sparse``, cuBLAS) as its yardstick;
   then ELL at edge shapes (row lengths 1-129 around the 32-slot rule, b =
   1, 3, 8, 11, a row count that is not a multiple of the tile, unaligned
   views) and on the symmetrized matrix S (L = 129) with its times; then
   the BSR window kernel at edge shapes (b = 1, 3, 8, 11, 2^17 - 5 rows,
   unaligned views and column strides, (8, 8) and (4, 4) blocks), every
   column of its b-column form bit for bit against its single-column
   form; then the staged 8 x 8 gather kernel (``spmv_bsr_cols``) at edge
   shapes (b = 2, 3, 8, 11, 16; 2^17 - 5 rows; 6 blocks a block-row; a
   rectangular operator; unaligned views), every column bit for bit
   against ``spmv_bsr``; each library yardstick is timed by CUDA events
   and by the profiler's device time;
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
8. solve G: the scattered 2^20 matrix as BSR-8, ``block_size=8`` (the
   staged 8 x 8 gather kernel, ``spmv_bsr_gather8_kernel``, on every
   b-column call), checked the same way;
9. solve H: the bandwidth-1024 matrix as BSR-8, scalar (BSR window kernel),
   checked against solve D's ARPACK values;
10. solve I: ``partial_eigh`` on ``laplace_2d(724)`` (DIA + fused CGS2),
    LA, k = 5, m = 80, through the device restart loop, checked against the
    analytic spectrum;
11. solve J: ``partial_eigh`` on the symmetrized scattered 2^20 matrix S
    (ELL b-column kernel + ``block_cgs2``), ``block_size=8``, LA, k = 5,
    m = 40, device loop, checked against ``scipy.sparse.linalg.eigsh``;
12. solve K: the same S, scalar, ``ortho="selective"`` (the host-
    orchestrated loop; ELL kernel, and the fused passes in the selective
    kernel's DGKS fallback), checked the same way;
13. solve L, the host tier: the bench's correctness gate (``laplace_2d(40,
    39)``, 4 LA pairs) and ``partial_schur(mark(100))`` LR against ARPACK,
    both passed as SciPy matrices with ``device="cuda"``: they must launch
    no kernel, run in the C++ host engine and return CUDA tensors;
14. solve M, refinement: ``partial_schur`` on the scattered matrix as ELL
    (float64 values) with ``dtype=float32``, tol 1e-8, LR, k = 5, m = 40:
    the float32 phase to 2e-4 (float32 ELL and CGS2 kernels), then the
    float64 continuation (float64 kernels); Q and T float64 on the card,
    checked against solve B's ARPACK values, matvecs of each phase printed;
15. solve N, refinement: ``partial_eigh`` on S, float32 to tol 1e-8, LA,
    k = 5, m = 40, checked against solve J's ``eigsh`` values;
16. solve O: ``svds`` of the reflected scattered matrix (the source of S),
    k = 5, LM, float64, tol 1e-8, m = 40: Lanczos on the Gram operator,
    ``spmv_ell`` on A and on the materialized A^T (``gram_companions``),
    checked against ``scipy.sparse.linalg.svds`` (ARPACK, tol 1e-10), the
    triplets ``||Av - su||``, ``||A^T u - sv||`` and orthonormality;
17. solve P: solve B's ELL operator wrapped as ``CallableOperator(op.matvec,
    ...)`` (the same matvec count as solve B), and a SciPy
    ``LinearOperator`` of mark(1000) (a host matvec), LR, k = 5, m = 40,
    ``device="cuda"``, against ARPACK (shift-invert just above 1);
18. ``rmatvec``/``rmatmat`` (b = 1, 8) of DIA, ELL and BSR-8 (gather and
    window) operators through their cached transposed operators, against
    cuSPARSE's ``A.T @ x``, bit-equal over two calls.

Solves M, N and O run twice and must count the same matvecs both times.
The solves of phases 2-13 run in float64 to tol 1e-8. ``partial_schur``
solves must give a Schur residual ``||AQ - QT|| / max|lambda| <= 1e-7`` and
eigenvalues within 1e-9 of the reference; ``partial_eigh`` solves a
residual ``||Av - lambda v|| / max|lambda| <= 1e-7``, orthonormal vectors
within 1e-10 and eigenvalues within 1e-9; the refined solves M and N meet
the same limits. A device solve that lands on the host tier fails the run.
The kernels' launch counters are zeroed just before phase 2 and read after
phase 13 (the main path), then zeroed before phase 14 and read after phase
17 (the refinement, svds and callable paths); every kernel must have
launched on the main path, ELL and both CGS2 kernels on the second, and
each solve must have launched the kernels of its operator. The line before
the last is a JSON object with each kernel's route, source, launches,
error, times, bound and library time; the last line is ``{"ok": true,
"device": {...}}``. Needs no network and imports nothing of JAX.
"""

import contextlib
import json
import os
import subprocess
import time

F64_LIMIT = 1e-12   # normwise relative error, float64
F32_LIMIT = 1e-5    # normwise relative error, float32

# The least time the card could take (bound_ms): the larger of the bytes a
# kernel must move over the HBM3 rate and its float64 flops over the CUDA
# cores' rate (NVIDIA's H100 SXM data sheet, 700 W; the tensor cores play no
# part).  Every timed case is float64, the main path's dtype.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 34e12


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


def device_ms(fn, reps=20, flush=None):
    """Mean profiler device time of ``fn()`` a call: the durations of the
    kernels and copies it launched, summed.  Unlike ``cuda_ms`` it leaves
    out the host's pace between launches, which sets the event time of
    kernels shorter than a launch's wrapper time.  With ``flush`` (a buffer
    larger than the 50 MB L2) zeroed before each call, ``fn`` reads its
    inputs from device memory, as it does in a solve; the zeroing's own
    device time, profiled alone, is taken off.  None where the profiler
    recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def per_call(body):
        body()
        sync()
        for _ in range(3):   # one profile on the H100 once recorded no device event
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    body()
                sync()
            us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA)
            if us > 0:
                return us / 1e3 / reps
        return None

    if flush is None:
        return per_call(fn)
    both, alone = per_call(lambda: (flush.zero_(), fn())), per_call(flush.zero_)
    return None if both is None or alone is None else both - alone


def rel_err(got, want):
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    denom = torch.linalg.vector_norm(want).item()
    diff = torch.linalg.vector_norm(got - want).item()
    return diff / (denom if denom else 1.0), (got - want).abs().max().item()


def bound(nbytes, flops):
    """``(bound_ms, bound_by)`` for a kernel that must move ``nbytes`` and
    do ``flops``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / FP64_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ell_bytes(op, nb):
    """Bytes an ELL product with ``nb`` columns must move: the matrix's
    nonzeros and their int32 ids once (not the padded slots), x and y."""
    item = op.data.element_size()
    n_rows, n_cols = op.shape
    return op.nnz * (item + 4) + nb * (n_rows + n_cols) * item


def csr_tensor(A, dtype, device):
    """``A`` as a torch CSR tensor with int32 indices on ``device`` (the
    cuSPARSE yardstick's operand, built outside any timed region)."""
    import numpy as np
    import torch

    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int32)).to(device),
        torch.from_numpy(A.indices.astype(np.int32)).to(device),
        torch.from_numpy(A.data).to(device=device, dtype=dtype), size=A.shape)


def bsr_tensor(A, dtype, device):
    """``A`` as a torch BSR tensor with (8, 8) blocks and int32 indices."""
    import numpy as np
    import torch

    B = A.tobsr(blocksize=(8, 8))
    return torch.sparse_bsr_tensor(
        torch.from_numpy(B.indptr.astype(np.int32)).to(device),
        torch.from_numpy(B.indices.astype(np.int32)).to(device),
        torch.from_numpy(B.data).to(device=device, dtype=dtype), size=B.shape)


class KernelRecord:
    """Errors, times and bound of one kernel over the phase-1 cases."""

    def __init__(self):
        self.max_abs_err = 0.0      # float64 cases (the main path's dtype)
        self.ms = None
        self.dev_ms = None          # profiler device time a call
        self.plain_ms = None
        self.bound_ms = None
        self.bound_by = None
        self.library_ms = None      # one PyTorch call computing the same function
        self.library_dev_ms = None  # that call's profiler device time
        self.library = "none"       # that call, or why there is none

    def time(self, kernel, plain, flush=None):
        """Time the kernel (CUDA events and profiler device time) and its
        plain version."""
        self.ms, self.dev_ms = cuda_ms(kernel), device_ms(kernel, flush=flush)
        self.plain_ms = cuda_ms(plain)

    def set_bound(self, nbytes, flops):
        self.bound_ms, self.bound_by = bound(nbytes, flops)

    def time_library(self, label, fn, want, flush=None):
        """Time ``fn`` (one PyTorch call, operands built beforehand) as this
        kernel's yardstick, by CUDA events and by the profiler's device time
        (with ``flush`` as the kernel's was taken), after checking it
        computes the same values."""
        rel, _ = rel_err(fn(), want)
        self.library, self.library_ms = label, cuda_ms(fn)
        self.library_dev_ms = device_ms(fn, flush=flush)
        dev = ("device not measured" if self.library_dev_ms is None
               else f"device {self.library_dev_ms:.4f} ms")
        print(f"  library {label}: {self.library_ms:.4f} ms, {dev} (rel err "
              f"against the plain version {rel:.1e})")

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
            r = rec["spmv_dia"]
            # Its 29 MB fit the 50 MB L2, where back-to-back launches would
            # find them; in a solve the CGS2 pass between two launches
            # streams the basis through L2, so the device time is taken cold.
            flush = torch.empty(2**23, dtype=torch.float64, device=dev)
            r.time(lambda: spmv_banded.banded_matvec(op.bands, x, op.offsets),
                   lambda: spmv_banded.banded_matvec_plain(op.bands, x, op.offsets),
                   flush=flush)
            n = op.shape[0]
            r.set_bound(op.bands.numel() * 8 + 2 * n * 8, 2 * op.bands.numel())
            A_csr = csr_tensor(mats["laplace"], dtype, dev)
            r.time_library("A_csr @ x (cuSPARSE SpMV)", lambda: A_csr @ x,
                           spmv_banded.banded_matvec_plain(op.bands, x, op.offsets),
                           flush=flush)
            del A_csr, flush

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
                r = rec["spmv_ell"]
                r.time(lambda: spmv_ell.ell_matvec(op.data, op.cols, x),
                       lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, x))
                r.set_bound(ell_bytes(op, 1), 2 * op.nnz)
                A_csr = csr_tensor(A, dtype, dev)
                r.time_library("A_csr @ x (cuSPARSE SpMV)", lambda: A_csr @ x,
                               spmv_ell.ell_matvec_plain(op.data, op.cols, x))
                del A_csr
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
                r = rec["masked_project"]
                r.time(lambda: ortho_fused.masked_project(Vs, w, na),
                       lambda: ortho_fused.masked_project_plain(Vs, w, na))
                r.set_bound((na * n + n + na) * 8, 2 * na * n)
                Va = Vs[:na]
                r.time_library("Vt[:k] @ w (cuBLAS gemv)", lambda: Va @ w, c_plain[:na])
                r = rec["project_update_norm"]
                r.time(lambda: ortho_fused.project_update_norm(Vs, w, c_plain, na),
                       lambda: ortho_fused.project_update_norm_plain(Vs, w, c_plain, na))
                r.set_bound((na * n + 2 * n + na + 1) * 8, 2 * na * n + 2 * n)
                # No one call also returns ||w'||^2: time the update alone,
                # as a yardstick for part of the function (library_ms stays
                # null).
                ca = c_plain[:na]
                partial = cuda_ms(lambda: torch.addmv(w, Va.T, ca, alpha=-1))
                r.library = (f"none (torch.addmv(w, Vt[:k].T, c, alpha=-1), the "
                             f"update without the norm: {partial:.4f} ms)")
                print(f"  library for project_update_norm: {r.library}")
                del Va, ca
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
    phase_ell_edges(mats, rec, gen)
    sync()
    phase_window_edges(rec, gen)
    sync()
    phase_gather_edges(rec, gen)
    sync()
    # The share of the bound against the event time and the device time:
    # they differ where the host paces the launches.
    for name, r in rec.items():
        lib = "none" if r.library_ms is None else f"{r.library_ms:.4f} ms"
        if r.library_dev_ms is not None:
            lib += f" (device {r.library_dev_ms:.4f} ms)"
        dev = ("device not measured" if r.dev_ms is None else
               f"device {r.dev_ms:.4f} ms, {100 * r.bound_ms / r.dev_ms:.0f} %")
        print(f"  time {name:<22} kernel {r.ms:.4f} ms   plain {r.plain_ms:.4f} ms   "
              f"bound {r.bound_ms:.4f} ms ({r.bound_by}; {100 * r.bound_ms / r.ms:.0f} %; "
              f"{dev})   library {lib}: {r.library}")
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
            r.time(kernel, plain)
        return timed and dtype == torch.float64

    # The tolerances: as above, each kernel sums the same products as its
    # plain version in another order (einsum or gather-then-sum there).
    dia64 = BandedOperator.from_scipy(mats["laplace"], device=dev)
    for dtype in (torch.float64, torch.float32):
        op = cast_operator(dia64, dtype)
        X = torch.randn(B_COLS, op.shape[0], generator=gen, device=dev, dtype=dtype)
        if case("spmv_dia_cols", f"DIA laplace_2d(724) b={B_COLS}", dtype,
                lambda: spmv_banded.banded_matmat(op.bands, X, op.offsets),
                lambda: spmv_banded.banded_matvec_plain(op.bands, X, op.offsets),
                timed=True):
            r, n = rec["spmv_dia_cols"], op.shape[0]
            r.set_bound(op.bands.numel() * 8 + 2 * B_COLS * n * 8,
                        2 * op.bands.numel() * B_COLS)
            A_csr, Xt = csr_tensor(mats["laplace"], dtype, dev), X.T.contiguous()
            r.time_library("A_csr @ Xt (cuSPARSE SpMM)", lambda: A_csr @ Xt,
                           spmv_banded.banded_matvec_plain(op.bands, X, op.offsets).T)
            del A_csr, Xt
        if not torch.equal(spmv_banded.banded_matmat(op.bands, X, op.offsets)[3],
                           spmv_banded.banded_matvec(op.bands, X[3], op.offsets)):
            fail("spmv_dia_cols: a column differs from the single-column kernel")
    del dia64, op, X

    ell64 = EllOperator.from_scipy(mats["scattered"], device=dev)
    for dtype in (torch.float64, torch.float32):
        op = cast_operator(ell64, dtype)
        X = torch.randn(B_COLS, op.shape[1], generator=gen, device=dev, dtype=dtype)
        if case("spmv_ell_cols", f"ELL scattered 2^20 b={B_COLS}", dtype,
                lambda: spmv_ell.ell_matmat(op.data, op.cols, X),
                lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, X),
                timed=True):
            r = rec["spmv_ell_cols"]
            r.set_bound(ell_bytes(op, B_COLS), 2 * op.nnz * B_COLS)
            A_csr, Xt = csr_tensor(mats["scattered"], dtype, dev), X.T.contiguous()
            r.time_library("A_csr @ Xt (cuSPARSE SpMM)", lambda: A_csr @ Xt,
                           spmv_ell.ell_matvec_plain(op.data, op.cols, X).T)
            del A_csr, Xt
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
            if timed and dtype == torch.float64:
                bsr_yardsticks(rec, timed, mats[key], op, x, X)
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


ELL_EDGE_L = (1, 4, 24, 25, 32, 33, 129)   # both sides of the 32-slot rule
ELL_EDGE_NB = (1, 3, 8, 11)                 # 11: a launch of 8 columns and one of 3
ELL_EDGE_SHAPE = (100_003, 70_001)          # rows (not a multiple of a tile), columns


def phase_ell_edges(mats, rec, gen):
    """Phase 1, ELL edge shapes: random rectangular ELL operators of
    ELL_EDGE_SHAPE (a row count that is not a multiple of the 32- or 64-row
    tile) at each row length in ELL_EDGE_L, b in ELL_EDGE_NB, float64 and float32,
    plus views one row in (not 16-byte aligned: the element-wise staging
    copies), each against the plain version; then the symmetrized matrix S
    (L = 129, solves J and K) timed against its bound and cuSPARSE."""
    import torch

    from arnoldi_tpu_torch.linop import EllOperator
    from arnoldi_tpu_torch.ops.kernels import spmv_ell

    dev = torch.device("cuda")
    n_rows, n_cols = ELL_EDGE_SHAPE
    times = {}
    for L in ELL_EDGE_L:
        data64 = torch.randn(n_rows, L, generator=gen, device=dev, dtype=torch.float64)
        cols = torch.randint(0, n_cols, (n_rows, L), generator=gen, device=dev,
                             dtype=torch.int32)
        for dtype in (torch.float64, torch.float32):
            data = data64.to(dtype)
            for nb in ELL_EDGE_NB:
                X = torch.randn(nb, n_cols, generator=gen, device=dev, dtype=dtype)
                label = f"ELL edge ({n_rows}, L={L}) x {n_cols}"
                if nb == 1:
                    rec["spmv_ell"].check(label, dtype,
                                          spmv_ell.ell_matvec(data, cols, X[0]),
                                          spmv_ell.ell_matvec_plain(data, cols, X[0]))
                    continue
                Y = spmv_ell.ell_matmat(data, cols, X)
                rec["spmv_ell_cols"].check(f"{label} b={nb}", dtype, Y,
                                           spmv_ell.ell_matvec_plain(data, cols, X))
                if not torch.equal(Y[nb - 1], spmv_ell.ell_matvec(data, cols, X[nb - 1])):
                    fail(f"spmv_ell_cols L={L} b={nb}: a column differs from the "
                         "single-column kernel")
            if L in (25, 33):
                dv, cv = data[1:], cols[1:]
                X = torch.randn(3, n_cols, generator=gen, device=dev, dtype=dtype)
                rec["spmv_ell"].check(f"ELL edge L={L}, view one row in", dtype,
                                      spmv_ell.ell_matvec(dv, cv, X[0]),
                                      spmv_ell.ell_matvec_plain(dv, cv, X[0]))
                rec["spmv_ell_cols"].check(f"ELL edge L={L}, view one row in, b=3",
                                           dtype, spmv_ell.ell_matmat(dv, cv, X),
                                           spmv_ell.ell_matvec_plain(dv, cv, X))
        x = torch.randn(n_cols, generator=gen, device=dev, dtype=torch.float64)
        X = torch.randn(B_COLS, n_cols, generator=gen, device=dev, dtype=torch.float64)
        # device time: at this size the host paces the launches
        times[L] = (device_ms(lambda: spmv_ell.ell_matvec(data64, cols, x)),
                    device_ms(lambda: spmv_ell.ell_matmat(data64, cols, X)))
        del data64, data, cols, X, x
    for L, (one, eight) in times.items():
        nnz = n_rows * L
        b1 = bound(nnz * 12 + (n_rows + n_cols) * 8, 2 * nnz)[0]
        b8 = bound(nnz * 12 + B_COLS * (n_rows + n_cols) * 8, 2 * nnz * B_COLS)[0]
        print(f"  ELL edge L={L:<3} float64, device time: spmv_ell {one:.4f} ms "
              f"({100 * b1 / one:.0f} % of bound {b1:.4f}), b={B_COLS} {eight:.4f} ms "
              f"({100 * b8 / eight:.0f} % of bound {b8:.4f})")

    S = mats["symmetric"]
    op = EllOperator.from_scipy(S, device=dev)
    x = torch.randn(op.shape[1], generator=gen, device=dev, dtype=torch.float64)
    X = torch.randn(B_COLS, op.shape[1], generator=gen, device=dev, dtype=torch.float64)
    out = {"L": op.data.shape[1], "nnz": op.nnz}
    for tag, nb, kernel, plain in (
            ("spmv_ell", 1, lambda: spmv_ell.ell_matvec(op.data, op.cols, x),
             lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, x)),
            ("spmv_ell_cols", B_COLS, lambda: spmv_ell.ell_matmat(op.data, op.cols, X),
             lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, X))):
        r = KernelRecord()
        r.check(f"ELL S (L={out['L']}) b={nb}", torch.float64, kernel(), plain())
        rec[tag].max_abs_err = max(rec[tag].max_abs_err, r.max_abs_err)
        r.time(kernel, plain)
        r.set_bound(ell_bytes(op, nb), 2 * op.nnz * nb)
        A_csr = csr_tensor(S, torch.float64, dev)
        if nb == 1:
            r.time_library("S_csr @ x (cuSPARSE SpMV)", lambda: A_csr @ x, plain())
        else:
            Xt = X.T.contiguous()
            r.time_library("S_csr @ Xt (cuSPARSE SpMM)", lambda: A_csr @ Xt, plain().T)
            del Xt
        del A_csr
        stored = op.data.numel() * 12 + nb * 2 * op.shape[0] * 8
        out[tag] = {"ms": r.ms, "dev_ms": r.dev_ms, "plain_ms": r.plain_ms,
                    "bound_ms": r.bound_ms,
                    "library_ms": r.library_ms,
                    "stored_bytes_TBps": stored / r.ms / 1e9}
    print(f"  ELL S: {json.dumps(out)}")
    del op, x, X


WINDOW_EDGE_NB = (1, 3, 8, 11)   # 11: a pass of 8 columns and one of 3


def phase_window_edges(rec, gen):
    """Phase 1, window kernel edge shapes: a banded matrix of 2^17 - 5
    rows (not a multiple of the 128-block-row tile, and a column stride
    that is not 16-byte aligned: the 4/8-byte copy path for b > 1) as
    BSR-8 and as BSR (4, 4) (the general window kernel), b in
    WINDOW_EDGE_NB, float64 and float32, and x / X as views one element in
    (unaligned pointer: the same copy path), each against the plain
    version; every column of the b-column form bit for bit against the
    single-column window kernel, and the 8 x 8 window kernel against the
    gather kernel."""
    import torch

    from arnoldi_tpu_torch import as_operator, matrices
    from arnoldi_tpu_torch.linop import cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    dev = torch.device("cuda")
    n = 2**17 - 5
    A = matrices.random_scattered(2**17, 24, seed=3, bandwidth=1024,
                                  block=8)[:n, :n].tocsr()
    for shape in ((8, 8), (4, 4)):
        op64 = as_operator(A, format=("bsr", shape), device=dev)
        if not op64.uses_window:
            fail(f"window edges: the BSR {shape} operator should take the window kernel")
        for dtype in (torch.float64, torch.float32):
            op = cast_operator(op64, dtype)
            blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
            label = f"BSR window edge {shape} ({n} rows, Wt={win.width})"
            for nb in WINDOW_EDGE_NB:
                for view in (False, True):
                    buf = torch.randn(nb * n + view, generator=gen, device=dev,
                                      dtype=dtype)
                    X = buf[int(view):].view(nb, n)
                    tag = f"{label} b={nb}{', view one in' if view else ''}"
                    if nb == 1:
                        rec["spmv_bsr_window"].check(
                            tag, dtype, spmv_bsr.bsr_window_matvec(blk, win, X[0], nr),
                            spmv_bsr.bsr_window_matvec_plain(blk, win, X[0], nr))
                        continue
                    Y = spmv_bsr.bsr_window_matmat(blk, win, X, nr)
                    rec["spmv_bsr_window_cols"].check(
                        tag, dtype, Y, spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr))
                    for j in range(nb):
                        if not torch.equal(Y[j], spmv_bsr.bsr_window_matvec(
                                blk, win, X[j].contiguous(), nr)):
                            fail(f"{tag}: column {j} differs from the single-column "
                                 "window kernel")
                    if shape == (8, 8) and not torch.equal(
                            Y, spmv_bsr.bsr_matmat(blk, ids, X, nr)):
                        fail(f"{tag}: window and gather kernels differ")
        del op64, op, blk, ids, win


GATHER_EDGE_NB = (2, 3, 8, 11, 16)   # 11, 16: passes of 8 columns re-read the blocks


def phase_gather_edges(rec, gen, device="cuda"):
    """Phase 1, gather kernel edge shapes at b >= 2 (8 x 8 blocks: the
    staged gather kernel): a scattered matrix of 2^17 - 5 rows with
    bandwidth 2^14 (its window exceeds the budget, so the operator routes
    to the gather kernel; the odd column count takes the value-by-value
    copies and leaves the last block-column part empty), one of 2^17 rows
    with 6 blocks a block-row (L not a multiple of the 4 slots a step;
    16-byte copies), and a rectangular operator (40,003 x 70,002: an odd
    block-row count, a partial last block-row, 16-byte copies in float64),
    b in GATHER_EDGE_NB, float64 and float32, X aligned and as a view one
    element in (value-by-value copies), each against the plain version and
    every column bit for bit against the single-column kernel.
    ``device="cpu"`` rehearses it with the plain versions (no launch or
    bit checks)."""
    import torch

    from arnoldi_tpu_torch import as_operator, matrices
    from arnoldi_tpu_torch.linop import cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    dev = torch.device(device)
    n = 2**17 - 5
    shapes = (
        ("scattered", matrices.random_scattered(2**17, 24, seed=3, bandwidth=2**14,
                                                block=8)[:n, :n].tocsr()),
        ("scattered L=6", matrices.random_scattered(2**17, 40, seed=5,
                                                    bandwidth=2**14, block=8)),
        ("rectangular", rectangular(40_003, 70_002, max_degree=3, seed=1)),
    )
    for name, A in shapes:
        op64 = as_operator(A, format=("bsr", (8, 8)), device=dev)
        if op64.uses_window:
            fail(f"gather edges: the {name} operator should take the gather kernel")
        for dtype in (torch.float64, torch.float32):
            op = cast_operator(op64, dtype)
            blk, ids, nr, nc = op.blocks, op.block_cols, op.n_rows, op.n_cols
            label = f"BSR gather edge {name} {tuple(blk.shape)} x {nc}"
            for nb in GATHER_EDGE_NB:
                for view in (False, True):
                    buf = torch.randn(nb * nc + view, generator=gen, device=dev,
                                      dtype=dtype)
                    X = buf[int(view):].view(nb, nc)
                    tag = f"{label} b={nb}{', view one in' if view else ''}"
                    before = spmv_bsr.bsr_matmat.gather8_launches
                    Y = spmv_bsr.bsr_matmat(blk, ids, X, nr)
                    if dev.type == "cuda" and \
                            spmv_bsr.bsr_matmat.gather8_launches != before + 1:
                        fail(f"{tag}: the staged gather kernel did not launch")
                    rec["spmv_bsr_cols"].check(
                        tag, dtype, Y, spmv_bsr.bsr_matvec_plain(blk, ids, X, nr))
                    for j in range(nb if dev.type == "cuda" else 0):
                        if not torch.equal(Y[j], spmv_bsr.bsr_matvec(
                                blk, ids, X[j].contiguous(), nr)):
                            fail(f"{tag}: column {j} differs from the single-column "
                                 "gather kernel")
        del op64, op, blk, ids


def bsr_yardsticks(rec, names, A, op, x, X):
    """Bounds and cuSPARSE yardsticks of the BSR kernels in ``names``, at
    BSR-8 ``op`` of the SciPy matrix ``A`` (float64).  The bytes count the
    matrix's nonzeros and its nonzero blocks' ids, not zero fill or padding."""
    import torch

    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    nnz = A.nnz
    nnzb = int((op.blocks != 0).any(-1).any(-1).sum())
    io = (op.n_rows + op.n_cols) * 8
    A_bsr, Xt = bsr_tensor(A, torch.float64, x.device), X.T.contiguous()
    for name in names:
        cols = name.endswith("_cols")
        nb = B_COLS if cols else 1
        rec[name].set_bound(nnz * 8 + nnzb * 4 + nb * io, 2 * nnz * nb)
        want = spmv_bsr.bsr_matvec_plain(op.blocks, op.block_cols, X if cols else x,
                                         op.n_rows)
        fn = (lambda: A_bsr @ Xt) if cols else (lambda: A_bsr @ x)
        rec[name].time_library(f"A_bsr @ {'Xt' if cols else 'x'} (cuSPARSE "
                               f"BSR {'SpMM' if cols else 'SpMV'}, blocks (8, 8))",
                               fn, want.T if cols else want)
    del A_bsr, Xt


def solve(label, op, nev, which, max_dim, sync_counts, block_size=1, p=None,
          max_restarts=1000, dtype=None, device=None):
    """One partial_schur solve on the card (in ``dtype``, default float64);
    returns (Q, T, hist, wall)."""
    import torch

    from arnoldi_tpu_torch import partial_schur

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q, T, hist = partial_schur(op, nev, max_dim=max_dim, stopping_criterion=1e-8,
                               sort_function=which,
                               dtype=dtype or torch.float64, ortho="cgs2",
                               max_restarts=max_restarts,
                               block_size=block_size, p=p, device=device)
    sync()
    wall = time.perf_counter() - t0
    report_solve(label, hist, wall, sync_counts)
    return Q, T, hist, wall


def report_solve(label, hist, wall, sync_counts, host_tier=False):
    """Print a solve's numbers; fail if it ran on the wrong tier."""
    import torch

    mv = hist.total_matvecs
    print(f"  {label}: wall {wall:.4f} s, matvecs {mv}, restarts "
          f"{len(hist.residual_trace)}, {1e3 * wall / mv:.4f} ms/matvec, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  launches so far: {sync_counts()}")
    print(f"  phases: {json.dumps(hist.phases)}")
    on_host = any(k.startswith(("engine.", "host.")) for k in hist.phases)
    if on_host != host_tier:
        fail(f"{label} ran on the {'host tier' if on_host else 'device'}")


def eigh_solve(label, op, nev, max_dim, sync_counts, dtype=None, **kw):
    """One partial_eigh solve on the card (in ``dtype``, default float64);
    returns (vals, V, hist, wall)."""
    import torch

    from arnoldi_tpu_torch import partial_eigh

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vals, V, hist = partial_eigh(op, nev, which="LA", max_dim=max_dim,
                                 stopping_criterion=1e-8,
                                 dtype=dtype or torch.float64, **kw)
    sync()
    wall = time.perf_counter() - t0
    report_solve(label, hist, wall, sync_counts)
    return vals, V, hist, wall


def eigh_residual(label, A, vals, V):
    """Residual ||Av - lambda v|| / max|lambda| and orthonormality of V."""
    import numpy as np

    Vh = V.double().cpu().numpy()
    res = np.linalg.norm(A @ Vh - Vh * vals[None, :], axis=0) / np.abs(vals).max()
    orth = np.abs(Vh.T @ Vh - np.eye(len(vals))).max()
    print(f"  eigenvalues {vals}")
    print(f"  residual / max|lambda| {res.max():.3e} (limit 1e-7); "
          f"|V^T V - I| {orth:.3e} (limit 1e-10)")
    if not (res.max() <= 1e-7 and orth <= 1e-10):
        fail(f"{label}: residual or orthonormality out of bounds")


def check_laplace_eigh(label, A, vals, V, side):
    """Hold an LA laplace_2d(side) partial_eigh solve against the analytic
    spectrum: each value within 1e-9 of its nearest exact eigenvalue (a
    scalar Krylov space may miss one copy of a double eigenvalue), and the
    largest one found."""
    import numpy as np

    from arnoldi_tpu_torch import matrices

    eigh_residual(label, A, vals, V)
    exact = np.sort(matrices.laplace_2d_eigen(side))
    err = np.abs(exact[None, :] - vals[:, None]).min(axis=1).max()
    top_err = abs(vals.max() - exact.max())
    print(f"  eigenvalue error {err:.3e} (limit 1e-9); largest eigenvalue "
          f"error {top_err:.3e} (limit 1e-9)")
    if not (err <= 1e-9 and top_err <= 1e-9):
        fail(f"{label} disagrees with the analytic spectrum")


def check_eigsh(label, A, vals, V, ref):
    """Hold a partial_eigh solve against eigsh's values."""
    import numpy as np

    eigh_residual(label, A, vals, V)
    err = np.abs(np.sort(vals) - np.sort(ref)).max()
    print(f"  eigsh: {np.sort(ref)}; matched eigenvalue error {err:.3e} "
          "(limit 1e-9)")
    if not err <= 1e-9:
        fail(f"{label} disagrees with eigsh")


def check_laplace(label, A, Q, T, side):
    """Hold a laplace_2d(side) solve against the analytic spectrum."""
    import numpy as np

    from arnoldi_tpu_torch import matrices

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


def reflected_scattered(n, seed=1, bandwidth=2**14):
    """The scattered matrix with reflected edges: the default clipped edges
    pile the edge rows' blocks into the first and last block-columns, hub
    columns that ELL and BSR refuse once transposed.  Its symmetric part
    ``(A + A^T) / 2`` is S."""
    from arnoldi_tpu_torch import matrices

    return matrices.random_scattered(n, 24, seed=seed,
                                     bandwidth=min(bandwidth, n // 4), block=8,
                                     edge="reflect")


def phase_hermitian(mats, counts, refs, device="cuda"):
    """Phases 10-13: partial_eigh on the card (solves I, J, K) and the host
    tier (solve L).  Puts S's eigsh values in ``refs["S"]``; returns
    [(label, history, wall), ...]."""
    import numpy as np
    import torch
    from scipy.sparse.linalg import eigs, eigsh

    from arnoldi_tpu_torch import as_operator, partial_eigh, partial_schur
    from arnoldi_tpu_torch import matrices

    # cuSOLVER loads on its first eigh; keep that out of solve I's wall.
    t0 = time.perf_counter()
    torch.linalg.eigh(torch.eye(80, dtype=torch.float64, device=device))
    sync()
    print(f"first torch.linalg.eigh on the card: {time.perf_counter() - t0:.3f} s")

    print("phase 10: solve I, partial_eigh laplace_2d(724), LA, k=5, m=80, "
          "cgs2, device loop")
    A = mats["laplace"]
    side = round(A.shape[0] ** 0.5)
    op = as_operator(A, dtype=torch.float64, device=device)
    before = counts()
    vals, V, hist_i, wall_i = eigh_solve("solve I", op, 5, 80, counts,
                                         ortho="cgs2", max_restarts=5000)
    check_launched("solve I", before, counts(),
                   ("spmv_dia", "masked_project", "project_update_norm"))
    if "trl.device_loop" not in hist_i.phases:
        fail("solve I did not run the device loop")
    check_laplace_eigh("solve I", A, vals, V, side)
    del V, op

    S = mats["symmetric"]
    t0 = time.perf_counter()
    ref = refs["S"] = eigsh(S, 5, which="LA", tol=1e-8, ncv=40,
                            return_eigenvectors=False)
    print(f"  eigsh on S (host, ncv=40) {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    op = as_operator(S, dtype=torch.float64, device=device)
    sync()
    print(f"  operator {type(op).__name__} L={op.data.shape[1]} nnz={op.nnz} "
          f"built in {time.perf_counter() - t0:.3f} s")
    if type(op).__name__ != "EllOperator":
        fail("S should route to ELL")

    print(f"phase 11: solve J, partial_eigh S (n = 2^20), block_size={B_COLS}, "
          "LA, k=5, m=40, device loop")
    before = counts()
    vals, V, hist_j, wall_j = eigh_solve("solve J", op, 5, 40, counts,
                                         block_size=B_COLS)
    check_launched("solve J", before, counts(), ("spmv_ell_cols",))
    if "trl.device_loop" not in hist_j.phases:
        fail("solve J did not run the device loop")
    check_eigsh("solve J", S, vals, V, ref)
    del V

    print("phase 12: solve K, partial_eigh S, scalar, ortho='selective', LA, "
          "k=5, m=40")
    before = counts()
    vals, V, hist_k, wall_k = eigh_solve("solve K", op, 5, 40, counts,
                                         ortho="selective")
    check_launched("solve K", before, counts(),
                   ("spmv_ell", "masked_project", "project_update_norm"))
    check_eigsh("solve K", S, vals, V, ref)
    del V, op

    print("phase 13: solve L, the host tier: SciPy input with device='cuda'")
    before = counts()
    nx, ny = 40, 39          # bench.py's correctness gate
    A = matrices.laplace_2d(nx, ny)
    t0 = time.perf_counter()
    vals, V, hist_l = partial_eigh(A, 4, which="LA", stopping_criterion=1e-8,
                                   max_restarts=3000, dtype=np.float64,
                                   device=device)
    sync()
    wall_l = time.perf_counter() - t0
    report_solve("solve L, bench gate", hist_l, wall_l, counts, host_tier=True)
    want = np.sort(matrices.laplace_2d_eigen(nx, ny))[-4:]
    err = float(np.abs(np.sort(vals) - want).max())
    Vh = V.cpu().numpy()
    res = float(np.linalg.norm(A @ Vh - Vh * vals[None, :], axis=0).max())
    print(f"  gate: eigenvalue error {err:.3e}, residual {res:.3e} "
          "(limits 100 tol = 1e-6)")
    if not (err < 1e-6 and res < 1e-6):
        fail("solve L failed the bench's correctness gate")
    hosts = [(hist_l, V)]

    A = matrices.mark(100)
    t0 = time.perf_counter()
    Q, T, hist_l2 = partial_schur(A, 5, sort_function="LR", max_dim=20,
                                  stopping_criterion=1e-8, max_restarts=1000,
                                  device=device)
    sync()
    wall_l2 = time.perf_counter() - t0
    report_solve("solve L, mark(100) LR", hist_l2, wall_l2, counts,
                 host_tier=True)
    check_arpack("solve L, mark(100)", A, Q, T,
                 eigs(A, 5, which="LR", tol=1e-8, return_eigenvectors=False))
    hosts.append((hist_l2, Q))
    for hist, out in hosts:
        if out.device.type != torch.device(device).type:
            fail(f"solve L returned a {out.device} tensor, not a {device} one")
        if "engine.expand" not in hist.phases:
            fail("solve L did not run in the C++ host engine")
    if counts() != before:
        fail(f"solve L launched kernels: {before} -> {counts()}")
    return [("I", hist_i, wall_i), ("J", hist_j, wall_j), ("K", hist_k, wall_k),
            ("L_gate", hist_l, wall_l), ("L_mark100", hist_l2, wall_l2)]


@contextlib.contextmanager
def continuation_matvecs():
    """A list that collects the matvecs of each float64 continuation that
    the refined solves inside the block run (``refine.refine_schur``
    wrapped for its duration): a refined solve's history counts both
    phases together."""
    from arnoldi_tpu_torch.solvers import refine

    inner, seen = refine.refine_schur, []

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out[3])
        return out

    refine.refine_schur = counted
    try:
        yield seen
    finally:
        refine.refine_schur = inner


def check_refined(label, hist, outs, seen, device):
    """A refined solve: float64 results on ``device``, one continuation,
    ``refine.continue`` among the phases.  Returns (float32 phase's,
    continuation's) matvecs."""
    import torch

    for t in outs:
        if t.dtype != torch.float64 or t.device.type != torch.device(device).type:
            fail(f"{label} returned a {t.dtype} tensor on {t.device}, not "
                 f"float64 on {device}")
    if "refine.continue" not in hist.phases or len(seen) != 1:
        fail(f"{label} did not continue in float64 once: {seen}")
    split = (hist.total_matvecs - seen[0], seen[0])
    print(f"  matvecs: float32 phase {split[0]}, float64 continuation {split[1]}")
    return split


def twice(label, run):
    """Run a solve twice (``run()`` returns ``(..., hist, wall)``); fail
    unless both count the same matvecs (the kernels reduce in a fixed
    order, so a rerun repeats every bit).  Returns the second run's."""
    first, second = run(), run()
    if first[-2].total_matvecs != second[-2].total_matvecs:
        fail(f"{label}: {first[-2].total_matvecs} matvecs, then "
             f"{second[-2].total_matvecs}")
    print(f"  {label} again: {second[-2].total_matvecs} matvecs, the same; "
          f"walls {first[-1]:.4f} / {second[-1]:.4f} s")
    return second


def short(kernel_name):
    """A profiler kernel name without its return type and namespace, cut
    to 60 characters (the template arguments show the dtype)."""
    name = kernel_name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name[:60]


def device_split(label, run):
    """One more warm run of a solve under the profiler: its device time
    (kernel and copy rows) by kernel name, and the busy share of the
    profiled wall.  Returns ``{"device_ms": ..., "busy": ...}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        sync()
    wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    total = sum(by_name.values())
    busy = total / 1e3 / wall if wall else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {label} under the profiler: wall {wall:.4f} s, device {total:.3f} ms "
          f"(busy {100 * busy:.1f} %); by kernel (ms): "
          + "; ".join(f"{short(name)} {ms:.3f}" for name, ms in top))
    return {"profiled_wall_s": wall, "device_ms": total, "busy": busy}


def phase_refine_svd(mats, counts, refs, device="cuda"):
    """Phases 14-17: the refined solves M (``partial_schur``) and N
    (``partial_eigh``), the partial SVD O (``svds``) and the callable
    operators P.  ``refs``: solve B's ARPACK values and matvecs, S's eigsh
    values.  M, N and O run once more under the profiler (``device_split``,
    with ``device="cuda"``).  Returns ``([(label, history, wall), ...],
    {label: {summary field: value}})``: the float32 phase's and the
    continuation's matvecs, device time and busy share."""
    import numpy as np
    import torch
    from scipy.sparse.linalg import aslinearoperator, eigs
    from scipy.sparse.linalg import svds as scipy_svds

    from arnoldi_tpu_torch import CallableOperator, as_operator, svds
    from arnoldi_tpu_torch.solvers.svd import gram_companions

    rows, extra = [], {}
    profiled = device_split if torch.device(device).type == "cuda" else (
        lambda label, run: {})
    print("phase 14: solve M, partial_schur refined: the scattered matrix as "
          "ELL (float64 values), float32 to tol 1e-8, LR, k=5, m=40")
    A = mats["scattered"]
    op = as_operator(A, dtype=torch.float64, device=device)
    before = counts()
    def run_m():
        return solve("solve M", op, 5, "LR", 40, counts, dtype=torch.float32)

    with continuation_matvecs() as seen:
        Q, T, hist_m, wall_m = twice("solve M", run_m)
    check_launched("solve M", before, counts(),
                   ("spmv_ell", "masked_project", "project_update_norm"))
    if seen[0] != seen[1]:
        fail(f"solve M: continuations of {seen} matvecs")
    f32, f64 = check_refined("solve M", hist_m, (Q, T), seen[1:], device)
    check_arpack("solve M", A, Q, T, refs["B"])
    rows.append(("M", hist_m, wall_m))
    del Q, T
    extra["M"] = dict(float32_matvecs=f32, float64_matvecs=f64,
                      **profiled("solve M", run_m))

    print("phase 15: solve N, partial_eigh refined: S as ELL (float64 "
          "values), float32 to tol 1e-8, LA, k=5, m=40, scalar")
    S = mats["symmetric"]
    op = as_operator(S, dtype=torch.float64, device=device)
    before = counts()
    def run_n():
        return eigh_solve("solve N", op, 5, 40, counts, dtype=torch.float32)

    with continuation_matvecs() as seen:
        vals, V, hist_n, wall_n = twice("solve N", run_n)
    check_launched("solve N", before, counts(),
                   ("spmv_ell", "masked_project", "project_update_norm"))
    if seen[0] != seen[1]:
        fail(f"solve N: continuations of {seen} matvecs")
    f32, f64 = check_refined("solve N", hist_n, (V,), seen[1:], device)
    if vals.dtype != np.float64:
        fail(f"solve N returned {vals.dtype} eigenvalues")
    check_eigsh("solve N", S, vals, V, refs["S"])
    rows.append(("N", hist_n, wall_n))
    del V
    extra["N"] = dict(float32_matvecs=f32, float64_matvecs=f64,
                      **profiled("solve N", run_n))
    del op

    print("phase 16: solve O, svds of the reflected scattered matrix (the "
          "source of S), k=5, LM, float64, tol 1e-8, m=40: Lanczos on A^T A")
    A = mats["reflect"]
    t0 = time.perf_counter()
    ref = np.sort(scipy_svds(A, 5, solver="arpack", tol=1e-10,
                             return_singular_vectors=False))
    print(f"  ARPACK svds (host, tol 1e-10) {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    op = as_operator(A, dtype=torch.float64, device=device)
    companions = gram_companions(A, op)
    sync()
    print(f"  A: {type(op).__name__} L={op.data.shape[1]}; A^T: "
          f"{type(companions[0]).__name__} L={companions[0].data.shape[1]}; "
          f"built in {time.perf_counter() - t0:.3f} s")

    def run_o():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = svds(op, 5, which="LM", tol=1e-8, ncv=40, dtype=torch.float64,
                   companions=companions, return_history=True)
        sync()
        wall = time.perf_counter() - t0
        report_solve("solve O", out[3], wall, counts)
        return (*out, wall)

    before = counts()
    U, s, Vh, hist_o, wall_o = twice("solve O", run_o)
    check_launched("solve O", before, counts(), ("spmv_ell",))
    Uh, Vt = U.cpu().numpy(), Vh.cpu().numpy().T
    sv_err = float(np.abs(s - ref).max() / ref.max())
    r_av = float(np.linalg.norm(A @ Vt - Uh * s, axis=0).max() / s.max())
    r_atu = float(np.linalg.norm(A.T @ Uh - Vt * s, axis=0).max() / s.max())
    orth = max(np.abs(Uh.T @ Uh - np.eye(5)).max(),
               np.abs(Vt.T @ Vt - np.eye(5)).max())
    print(f"  singular values {s}; ARPACK {ref}")
    print(f"  relative error {sv_err:.3e} (limit 1e-9); |Av - su| / s_max "
          f"{r_av:.3e}, |A^T u - sv| / s_max {r_atu:.3e} (limits 1e-7); "
          f"orthonormality {orth:.3e} (limit 1e-10)")
    if not (sv_err <= 1e-9 and r_av <= 1e-7 and r_atu <= 1e-7 and orth <= 1e-10):
        fail("solve O disagrees with ARPACK's svds or its triplets are off")
    rows.append(("O", hist_o, wall_o))
    del U, Vh
    extra["O"] = profiled("solve O", run_o)
    del op, companions

    print("phase 17: solve P, CallableOperator(op.matvec) of solve B's ELL "
          "operator, and a SciPy LinearOperator (mark(1000), LR, k=5)")
    A = mats["scattered"]
    op = as_operator(A, dtype=torch.float64, device=device)
    fn_op = CallableOperator(op.matvec, op.shape, op.dtype, device=op.device)
    before = counts()
    Q, T, hist_p, wall_p = solve("solve P", fn_op, 5, "LR", 40, counts)
    check_launched("solve P", before, counts(), ("spmv_ell",))
    if hist_p.total_matvecs != refs["B_matvecs"]:
        fail(f"solve P: {hist_p.total_matvecs} matvecs, solve B "
             f"{refs['B_matvecs']}: the same kernel should repeat its bits")
    check_arpack("solve P", A, Q, T, refs["B"])
    rows.append(("P", hist_p, wall_p))
    del Q, op, fn_op
    M = mats["mark"]
    # ARPACK in shift-invert mode just above 1, the top of mark's real
    # spectrum: the five largest real values, ~8x faster than ARPACK's own
    # LR iteration on this clustered end (168 s on the card's host).
    t0 = time.perf_counter()
    ref = eigs(M, 5, sigma=1.001, which="LM", tol=1e-12,
               return_eigenvectors=False)
    print(f"  ARPACK shift-invert on mark(1000) (host, sigma 1.001) "
          f"{time.perf_counter() - t0:.2f} s")
    Q, T, hist_p2, wall_p2 = solve("solve P, SciPy LinearOperator mark(1000)",
                                   aslinearoperator(M), 5, "LR", 40, counts,
                                   device=device, max_restarts=5000)
    check_arpack("solve P, mark(1000)", M, Q, T, ref)
    rows.append(("P_linear_operator", hist_p2, wall_p2))
    return rows, extra


def phase_adjoint_edges(mats, device="cuda"):
    """Phase 18: ``rmatvec`` (b = 1) and ``rmatmat`` (b = 8) of DIA
    (laplace_2d(724)), ELL (the rectangular 200,000 x 300,000 matrix) and
    BSR-8 operators (the reflected scattered matrix: gather kernel; a
    reflected banded-1024 matrix of 2^18 rows: window kernel), float64 and
    float32: each through its cached transposed operator against
    ``A.T @ x`` from cuSPARSE, and bit-equal over two calls.  Its launches
    are checks and are not counted."""
    import torch

    from arnoldi_tpu_torch import as_operator, rmatmat, rmatvec
    from arnoldi_tpu_torch.linop import adjoint_operator, cast_operator

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = (
        ("DIA laplace_2d(724)", mats["laplace"], None, None),
        ("ELL rect", mats["rect"], "ell", None),
        ("BSR-8 gather, reflected scattered", mats["reflect"], ("bsr", (8, 8)),
         False),
        ("BSR-8 window, reflected banded-1024", mats["window_reflect"],
         ("bsr", (8, 8)), True),
    )
    for name, A, fmt, window in cases:
        op64 = as_operator(A, format=fmt, dtype=torch.float64, device=dev)
        for dtype in (torch.float64, torch.float32):
            op = cast_operator(op64, dtype)
            adj = adjoint_operator(op)
            if window is not None and adj.uses_window != window:
                fail(f"adjoint edges: {name}'s transpose should take the "
                     f"{'window' if window else 'gather'} kernel")
            At = csr_tensor(A.T.tocsr(), dtype, dev)
            limit = F64_LIMIT if dtype == torch.float64 else F32_LIMIT
            for nb in (1, 8):
                Y = torch.randn((A.shape[0], nb), generator=gen, dtype=dtype,
                                device=dev)
                if nb == 1:
                    y = Y[:, 0].contiguous()
                    got, again, want = rmatvec(op, y), rmatvec(op, y), At @ y
                else:
                    got, again, want = rmatmat(op, Y), rmatmat(op, Y), At @ Y
                rel, abs_err = rel_err(got, want)
                print(f"  adjoint {name} {tuple(A.shape)} {str(dtype):<14} b={nb}: "
                      f"{type(adj).__name__} L={adj_width(adj)}, rel {rel:.3e} "
                      f"max_abs {abs_err:.3e} (limit {limit:g}), bit-equal "
                      f"{torch.equal(got, again)}")
                if not (rel <= limit and torch.equal(got, again)):
                    fail(f"adjoint {name} {dtype} b={nb}: error {rel:.3e} or "
                         "unequal bits over two calls")
        del op64, op, adj, At


def adj_width(op):
    """The padded width of an operator's rows: ELL slots, BSR blocks or DIA
    diagonals."""
    return {"EllOperator": lambda: op.data.shape[1],
            "BsrOperator": lambda: op.blocks.shape[1],
            "BandedOperator": lambda: len(op.offsets)}[type(op).__name__]()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.environ["ARNOLDI_PHASES"] = "1"   # the tier checks read the phases

    from arnoldi_tpu_torch import as_operator
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.native import dense_tier as native_dense_tier
    from arnoldi_tpu_torch.native import host_engine
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    native = native_dense_tier.available()
    print(f"host dense tier: {'native C++' if native else 'SciPy LAPACK'} "
          f"({time.perf_counter() - t0:.2f} s to load or build)")
    t0 = time.perf_counter()
    engine = host_engine.available()
    print(f"host_engine.available(): {engine} "
          f"({time.perf_counter() - t0:.2f} s to load or build)")
    if not engine:
        fail("the C++ host engine did not build")
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
        "reflect": reflected_scattered(2**20),
        "window_reflect": reflected_scattered(2**18, seed=2, bandwidth=1024),
    }
    mats["symmetric"] = ((mats["reflect"] + mats["reflect"].T) / 2).tocsr()
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
    staged = spmv_bsr.bsr_matmat.gather8_launches
    Q, T, hist_g, wall_g = solve("solve G", op, 5, "LR", 40, counts,
                                 block_size=B_COLS)
    check_launched("solve G", before, counts(), ("spmv_bsr_cols",))
    staged = spmv_bsr.bsr_matmat.gather8_launches - staged
    print(f"  spmv_bsr_cols launches of the staged 8 x 8 gather kernel: {staged}")
    if staged != counts()["spmv_bsr_cols"] - before["spmv_bsr_cols"]:
        fail("solve G did not launch spmv_bsr_gather8_kernel on every b-column call")
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

    refs = {"B": ref_b, "B_matvecs": hist_b.total_matvecs}
    hermitian = phase_hermitian(mats, counts, refs)

    final = counts()
    missing = [k for k, v in final.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    print(f"launches on the main path (phases 2-13): {final}")

    # The refinement, svds and callable paths, counted on their own.
    kernels.reset_launch_counts()
    refined, extra = phase_refine_svd(mats, counts, refs)
    refine_path = counts()
    idle = [k for k in ("spmv_ell", "masked_project", "project_update_norm")
            if refine_path[k] == 0]
    if idle:
        fail(f"kernels of phases 14-17 never launched there: {idle}")
    print(f"launches on the refinement, svds and callable paths (phases "
          f"14-17): {refine_path}")

    print("phase 18: adjoint products through the transposed operators")
    phase_adjoint_edges(mats)

    summary = {label: {"matvecs": h.total_matvecs, "restarts": len(h.residual_trace),
                       "wall_s": w, "ms_per_matvec": 1e3 * w / h.total_matvecs}
               for label, h, w in (("A", hist_a, wall_a), ("B", hist_b, wall_b),
                                   ("C", hist_c, wall_c), ("D", hist_d, wall_d),
                                   ("E", hist_e, wall_e), ("F", hist_f, wall_f),
                                   ("G", hist_g, wall_g), ("H", hist_h, wall_h),
                                   *hermitian, *refined)}
    for label, fields in extra.items():
        summary[label].update(fields)
    print(f"solves: {json.dumps(summary)}")
    print(f"card: {smi}")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": final[name], "max_abs_err": rec[name].max_abs_err,
         "ms": rec[name].ms, "plain_ms": rec[name].plain_ms,
         "bound_ms": rec[name].bound_ms, "bound_by": rec[name].bound_by,
         "library_ms": rec[name].library_ms, "dev_ms": rec[name].dev_ms,
         "library_dev_ms": rec[name].library_dev_ms,
         "launches_phases_14_17": refine_path[name]}
        for name, (_, source, replaces) in kernels.KERNELS.items()]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
