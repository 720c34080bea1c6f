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
   kernels, and BSR-8 on a matrix whose n is not a multiple of 8, the
   fused CGS passes on gmres's (81, 2^20) basis (n_active 1, 40, 80) and
   DIA on the pencil's one-band mass matrix (b = 1 and 5); compute
   each kernel's bound (bytes over 3.35 TB/s or flops over the fp64 rate,
   whichever is larger) and time the one PyTorch call that computes the same
   function (cuSPARSE through ``torch.sparse``, cuBLAS) as its yardstick,
   each kernel (and each DIA form's yardstick) also by the host time a
   call takes to issue (the host clock over 1000 calls, read before the
   synchronize);
   then ELL at edge shapes (row lengths 1-129 around the 32-slot rule, b =
   1, 3, 8, 11, 67, 327, a row count that is not a multiple of the tile,
   unaligned views; every column of the b-column form bit for bit against
   the single-column form) and on the symmetrized matrix S (L = 129) with
   its times; then
   the BSR window kernel at edge shapes (b = 1, 3, 8, 11, 2^17 - 5 rows,
   unaligned views and column strides, (8, 8) and (4, 4) blocks), every
   column of its b-column form bit for bit against its single-column
   form; then the staged 8 x 8 gather kernel (``spmv_bsr_cols``) at edge
   shapes (b = 2, 3, 8, 11, 16; 2^17 - 5 rows; 6 blocks a block-row; a
   rectangular operator; unaligned views), every column bit for bit
   against ``spmv_bsr``; each library yardstick is timed by CUDA events
   and by the profiler's device time; then the complex forms of DIA, ELL
   and the two CGS2 passes in complex128 and complex64 at the complex
   solves' shapes, each against its plain version, timed beside its bound
   and its library call (cuSPARSE's complex CSR product, cuBLAS's
   ``Vt[:k].conj() @ w``); then the complex forms of both BSR kernels
   (gather and staged 8 x 8 gather on the phased scattered matrix, both
   window kernels on the phased banded-1024 matrix) in complex128 and
   complex64 at b = 1 and 8, the same way (cuSPARSE's complex BSR
   product), the complex128
   window kernel at b = 8 with 4 columns a pass in one stage (the plan) and
   2 in two stages, and complex128 edge shapes (the window kernels at b =
   1, 3, 4, 5, 8, 11 with (8, 8) and (4, 4) blocks, the staged gather
   kernel at b = 2, 3, 8, 11, 16; views one element in), every column bit
   for bit against the single-column kernel;
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
    cuSPARSE's ``A.T @ x``, bit-equal over two calls;
19. solve Q: ``partial_schur`` on the gauge-rotated ``laplace_2d(724)``,
    ``e^{i pi/6} G L G^H`` with ``G = diag(e^{i theta})`` (complex DIA +
    fused CGS2), complex128, LM, k = 5, m = 80, from ``G v0_A`` (solve A's
    start vector rotated: the unitary image of A's Krylov space), checked
    against ``e^{i pi/6}`` times the analytic spectrum;
20. solve R: the scattered 2^20 matrix with every off-diagonal value times
    ``e^{i phi}`` (complex ELL, the staged path), LR, k = 5, m = 40,
    checked against complex ARPACK;
21. solve U: R at ``block_size=8`` (complex ``spmv_ell_cols`` and
    ``block_cgs2``), and the gauge-rotated ``laplace_2d(200)`` at
    ``block_size=8`` (complex ``spmv_dia_cols``), LM, k = 5, m = 80, p = 40;
22. solve V: R's operator in complex64 to tol 1e-5 (no refinement), within
    1e-4 of R's eigenvalues;
23. solve T: ``partial_eigh`` of the Hermitian part of the phased
    reflected matrix (complex ELL, the warp path, L = 129), LA, k = 5,
    m = 40, device loop, checked against ``eigsh``;
24. solve W, the complex128 host tier: a phased mark(100) as SciPy input
    with ``device="cuda"``: no kernel launch, NumPy (the C++ engine is
    float64), CUDA results, checked against ARPACK;
25. ``svds`` of the phased reflected matrix (a complex Hermitian Gram
    operator; the adjoint leg is the conjugate-transposed ELL), checked
    against ARPACK's ``svds`` and the triplets;
26. solve X: ``eigsh(laplace_2d(724) as DIA, k=5, sigma=0.01, ncv=40,
    inner_solver="cg")`` (``spmv_dia`` in every CG iteration; the outer
    ``partial_eigh`` device loop with the fused CGS passes), checked
    against the exact values nearest sigma; once more under the profiler;
27. solve Y: ``eigs(the scattered 2^20 matrix as ELL, k=5, sigma=1.7,
    inner_solver="bicgstab")``, checked against solve B's ARPACK values
    (the five nearest 1.7);
28. solve Z: the same at sigma=1.42 (interior, indefinite) with
    ``inner_solver="gmres"`` (restart 80: an (81, 2^20) basis through the
    fused CGS passes), checked against the five nearest 1.42 of ARPACK's
    ten largest-real values (computed in the reference worker);
29. ``svds`` of the reflected scattered matrix at sigma = 1.1 s_max (solve
    O's ARPACK values), gmres on the shifted Gram operator (``spmv_ell`` on
    A and the materialized A^T), checked against solve O's values and the
    triplets;
30. the pencil: ``eigsh(laplace_2d(724), k=5, M=diag(m), sigma=0.01,
    inner_solver="cg")`` with m uniform on [0.5, 1.5] from seed 9 (DIA A
    and M in every CG iteration, the outer ``partial_schur``), checked
    against ARPACK's five values nearest sigma within 1e-9 (computed in the
    reference worker on M^-1/2 A M^-1/2), by ``||Ax - lambda Mx||``,
    ``diag(X^T M X) = 1`` within 1e-10 and its
    off-diagonal within 1e-6 (``eigsh`` M-normalizes, as the JAX
    package's does, and does not M-orthogonalize a close pair);
31. splu: ``eigsh(laplace_2d(300), k=5, sigma=0.01, inner_solver="splu",
    device="cuda")``: the LU and its solves on the host, the outer solve on
    the card, checked against the exact values.
Each of 26-31 prints its wall, outer matvecs, inner solves and matvecs
(``InnerSolveStats``) and the kernels it launched.  Their residuals are
taken against the spectrum's largest magnitude, not the small values a
shift-invert solve finds (``PERF.md`` §2).
32. ``eigsh_window(laplace_3d(64), (-11.93, -11.89), tol=1e-8)`` (n =
    262,144, DIA, float64): the KPM census, then one ``eigsh_filtered``
    slice after another, each filter step one ``spmv_dia_cols`` launch at
    b = the slice's s; every one of the 60 exact values inside the window
    within 1e-9, ``||Av - lambda v|| / max(|lmin|, |lmax|) <= 1e-7``,
    vectors orthonormal within 1e-10 inside a slice and, across slices,
    ``|<v_i, v_j>| <= (||r_i|| + ||r_j||) / |lambda_i - lambda_j|`` (an
    identity for a symmetric A; the JAX package's figures on its CPU tests
    printed beside it); prints the wall, matvecs, sweeps, each slice's s
    and degree, and the ``filter.*`` phases;
33. ``eigsh_filtered(laplace_3d(48) as ELL, nev=10, (-11.80, -11.77),
    tol=1e-8, dtype=float32)``: the float32 sweeps to 1e-5 or their stall
    (``spmv_ell_cols`` in float32), then the float64 continuation on the
    operator's float64 values (``spmv_ell_cols`` in float64); the 10 exact
    values nearest the window's center (36 inside it) within 1e-9, the
    same residual and orthonormality gates; each phase's matvecs printed;
34. ``explicit_restarts_with_deflation`` (nev 5, max_dim 40, LR, tol
    1e-10) on the scattered 2^20 matrix (ELL) against solve B's ARPACK
    values within 1e-9 (relative), and ``naive_explicit_restarts`` (m 20)
    against the largest of ARPACK's values of solve Z's reference, both
    in complex128 with the real ELL kernel applied to the real and
    imaginary parts as two columns; restarts and matvecs printed;
35. solve RB: the phased scattered matrix as complex128 BSR-8 (its window
    exceeds the budget: ``spmv_bsr``), LR, k = 5, m = 40, then
    ``block_size=8`` (``spmv_bsr_cols``, the staged 8 x 8 gather kernel on
    every call), each checked against solve R's ARPACK values;
36. solve DB: ``phased(random_scattered(2^20, 24, seed=2, bandwidth=1024,
    block=8))`` as complex128 BSR-8 (the window kernels), scalar and b = 8,
    against complex ARPACK (computed in the reference worker);
37. solve VB: RB's operator in complex64 to tol 1e-5, scalar and b = 8 (the
    complex64 gather forms), within 1e-4 of solve RB's values;
38. ``svds`` of DB's phased banded-1024 matrix and of its reflected form
    as complex128 BSR-8, k = 5, LM, tol 1e-8, m = 40: the adjoint leg is
    the materialized conjugate transpose, BSR through the same kernels
    (DB's clipped edge block-columns hold ~64 blocks, so its transpose
    splits those rows into virtual rows folded back after each product:
    ``linop.SplitRowsOperator``; the split is printed), each checked against
    ARPACK's ``svds`` and the triplets;
39. checkpoint/resume: solve A with ``max_restarts=50``,
    ``checkpoint_every=25`` into ``build/chip_smoke/`` must raise
    ``ValueError``; resumed from its snapshot to convergence it must count
    solve A's matvecs and restarts, with T within 1e-12 of solve A's;
    the snapshot's size and write times printed;
40. the DIA shard form (``spmv_dia_ext``, ``spmv_dia_ext_cols``) against its
    plain version at the 2-rank shard shapes of phases 42-44, both ranks,
    b = 1 and 8 (the block against its halo window, its first and its last
    h rows alone, and the block against the whole vector as the all-gather
    runs it): laplace_2d(724)'s (262,088 rows, h = 724) in float64 and
    complex128 and solve E9's 9-band layout (524,288 rows, h = 4) in
    float64; timed (laplace, float64 and complex128) beside its bound and
    cuSPARSE's CSR product of the shard's window, every device time over
    copies of the inputs that pass the L2 (``cold``), with the host
    enqueue time of both; then the rectangular
    ELL and BSR-8 shards of the scattered matrix (halo 2^14 rows, 2^11 block
    rows) against their plain versions, the BSR kernel printed;
41. solve A's configuration through ``sharded_partial_schur`` over a
    one-rank NCCL process group in this process with the ring-halo DIA
    operator (``halo_matvec_closure``): an all-reduce of one term is the
    identity, so it must count solve A's 2900 matvecs with T within 1e-12
    of solve A's;
42. two ranks sharing the card over gloo (spawned processes, the kernels
    loaded from this process's build; gloo's all-reduce and all-gather
    take CUDA tensors, its point-to-point does not, so the ring exchange
    stages through pinned host buffers): solve A's configuration over the DIA halo
    (analytic spectrum, matvecs printed beside solve A's), solve B's over
    the ELL halo and over the all-gather, solve C's over the BSR-8 halo
    (ARPACK), ``partial_eigh`` on solve I's (cgs2; analytic spectrum) and
    a symmetric 9-band 2^20-row matrix with separated top eigenvalues at
    ``block_size=8``, LR, k = 5, m = 40 over the DIA halo (the shard form's
    b-column kernel; against ``eigsh``); each prints its backend, kernel
    and the bytes a rank receives a matvec, and both ranks must count the
    same matvecs;
43. solve M's configuration over the 2-rank ELL halo: float32, then the
    float64 continuation on the halo operator's own values, to 1e-8,
    against ARPACK;
44. the sharded checkpoint: solve A's configuration on 2 ranks cut at
    restart 50 (a snapshot every 25: rank 0's metadata and a shard file a
    rank, sizes printed), resumed on 2 ranks (the unbroken 2-rank run's
    matvecs and T within 1e-12) and on one rank in this process (the
    analytic spectrum);
45. solve 32's configuration through ``eigsh_window(..., mesh=)`` on a
    one-rank NCCL mesh in this process over the DIA halo: it must count
    solve 32's matvecs, its values within 1e-12 of solve 32's;
46. two gloo ranks sharing the card (spawned as in phase 42): (a)
    ``eigsh_filtered(laplace_3d(64), nev=10, (-11.93, -11.89), tol=1e-8)``
    in float64 over the DIA halo (``spmv_dia_ext_cols`` at b = s), (b)
    solve 33's configuration over the ELL halo (``spmv_ell_cols`` on its
    rectangular column map, float32 then float64), each within 1e-9 of the
    exact spectrum, printing s, degree, sweeps, the bytes a rank receives
    an SpMV and each rank's launches, both ranks counting the same
    matvecs; (c) ``estimate_window_count`` on two ranks against one
    (relative 1e-10); one sweep of (a) under the profiler: device time by
    kernel family, the ring exchange's host time, the busy share;
47. the harness on the card: ``bench_partial_schur laplace2d:300 --which
    LM`` (the device path, ARPACK beside it), ``stress_test --quick
    laplace2d:200``, ``compare_arpack mark:100`` and ``scaling_bench`` on 1
    and 2 gloo ranks over laplace_2d(724)'s DIA halo, each printing what it
    prints; a stress row whose match is not True is settled against
    laplace_2d(200)'s exact spectrum (``settle_stress_rows``).
Between phases 46 and 47 (outside the counted window) ``spmv_dia_ext_cols``
on laplace_3d(64)'s 2-rank DIA shard is held against its plain version at
phase 45's and 46(a)'s s and at b = 297 (every column bit for bit against
the single-column kernel) and timed at b = 297 beside its bound and
cuSPARSE's SpMM of the window's CSR, and ``spmv_ell_cols`` on
laplace_3d(48)'s 2-rank ELL shard likewise at 46(b)'s s (timed in
float32 and float64).
After phase 34 (outside every counted window) ``spmv_dia_cols`` on
laplace_3d(64) and ``spmv_ell_cols`` on laplace_3d(48) as ELL are held
against their plain versions at the filter's widths (b = 32, 64, each
slice's s and 8 x 37 + 3) in float64 and float32 (every column of both
b-column kernels bit for bit against the single-column kernel) and timed
at b = s beside their bound and cuSPARSE's SpMM (DIA in float64 with both
enqueue times, ELL in float32 and float64); ten profiled ELL products at
phase 33's s must show one kernel a call; and one sweep of phase 32's
first slice (float64, DIA) and one of phase 33's geometry (float32, ELL)
run under the profiler (device time by kernel family, busy share).

Solves M, N and O run twice and must count the same matvecs both times;
Q, R, T and X run once more under the profiler. The complex solves',
solve Z's and the pencil's ARPACK references run in one worker process
(one BLAS thread) from the start of phase 1, so that they overlap the
card's work; it is closed or terminated before the script ends.
The solves of phases 2-13 run in float64 to tol 1e-8. ``partial_schur``
solves must give a Schur residual ``||AQ - QT|| / max|lambda| <= 1e-7`` and
eigenvalues within 1e-9 of the reference; ``partial_eigh`` solves a
residual ``||Av - lambda v|| / max|lambda| <= 1e-7``, orthonormal vectors
within 1e-10 and eigenvalues within 1e-9; the refined solves M and N meet
the same limits. A device solve that lands on the host tier fails the run.
The kernels' launch counters are zeroed just before phase 2 and read after
phase 13 (the main path), then zeroed before phase 14 and read after phase
17 (the refinement, svds and callable paths), then zeroed before phase 19
and read after phase 25 (the complex path, counted by dtype as well:
``kernels.dtype_launch_counts()``), then zeroed before phase 26 and read
after phase 31 (the shift-invert path), then zeroed before phase 32 and
read after phase 34 (the filtered and explicit-restart path, by dtype);
every kernel must have launched on the main path, ELL and both CGS2
kernels on the second, every complex form of DIA, ELL and the CGS2 pair in
complex128 and ELL and the CGS2 pair in complex64 on the third, DIA, ELL
and both CGS2 kernels on the fourth, ``spmv_dia_cols`` and ``spmv_dia`` in
float64, ``spmv_ell_cols`` in float32 and float64, ``spmv_ell`` in float32
and both CGS2 kernels on the fifth, every complex128 form of both BSR
kernels and the complex64 gather forms on the sixth (zeroed before phase
35, read after phase 39), both forms of ``spmv_dia_ext``, ELL, the BSR
kernel of solve C's shards and both CGS2 kernels on the sharded path
(zeroed before phase 41, read after phase 44, the spawned ranks' launches
added), both forms of ``spmv_dia_ext``, ``spmv_ell_cols`` and both CGS2
kernels on the sharded filter and the harness (zeroed before phase 45,
read after phase 47 but for the kernel checks between 46 and 47, the
spawned ranks' launches added), and each solve must have launched the kernels of its operator in
its dtype.
The line before the last is a JSON object with each kernel's route,
source, launches, error, times, bound and library time (and a record of
each complex form, named ``kernel:dtype``, whose launches are the complex
path's, and of ``spmv_dia_cols`` and ``spmv_ell_cols`` at the filter's
widths, named ``kernel:filter`` (``spmv_ell_cols:filter_f64`` for the
float64 ELL form), whose launches are phases 32-34's in its dtype, and of
each complex BSR form, named ``kernel:dtype`` too, whose
launches are phases 35-39's; ``spmv_dia_ext`` and ``spmv_dia_ext_cols``
count the sharded path's launches, phases 41-44; and of the halo shard
forms at b = s, ``spmv_dia_ext_cols:filter`` and ``spmv_ell_cols:halo``
(``:halo_f64`` in float64), whose launches are phases 45-46's, all
dtypes); the last line is
``{"ok": true, "device": {...}}``. Needs no network and imports nothing
of JAX.
"""

import contextlib
import json
import os
import subprocess
import time

F64_LIMIT = 1e-12   # normwise relative error, float64 and complex128
F32_LIMIT = 1e-5    # normwise relative error, float32 and complex64

# The least time the card could take (bound_ms): the larger of the bytes a
# kernel must move over the HBM3 rate and its flops over the CUDA cores'
# rate for their type (NVIDIA's H100 SXM data sheet, 700 W; the tensor cores
# play no part).  The real timed cases are float64, the main path's dtype; a
# complex multiply-add is 8 flops.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
FP64_FLOPS_PER_S = 34e12
FP32_FLOPS_PER_S = 67e12


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


def enqueue_us(fn, calls=1000):
    """Host microseconds ``fn()`` takes to issue its work: the host clock
    over ``calls`` calls, read before the synchronize that follows them."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    sync()
    return us


def device_ms(fn, reps=20):
    """Mean profiler device time of ``fn()`` a call: the durations of the
    kernels and copies it launched, summed.  Unlike ``cuda_ms`` it leaves
    out the host's pace between launches, which sets the event time of
    kernels shorter than a launch's wrapper time.  Give a kernel whose
    inputs fit the L2 as ``cold(kernel, *inputs)``.  None where the
    profiler recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):   # one profile on the H100 once recorded no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    return None


def tensor_bytes(t):
    """Bytes ``t`` holds: a dense tensor's elements, a CSR tensor's
    values and indices."""
    import torch

    if t.layout == torch.sparse_csr:
        return sum(tensor_bytes(u) for u in (t.values(), t.col_indices(),
                                             t.crow_indices()))
    return t.numel() * t.element_size()


def cold(fn, *inputs):
    """``fn`` (which takes ``inputs``) as a function of no arguments that
    cycles through copies of ``inputs``, the caller's first, enough to pass
    twice the card's L2 together.  Called back to back, as ``device_ms``
    calls it, each call then reads its inputs from device memory, as a
    solve's call does (the basis streams through L2 between two products),
    and not from the L2 the call before left them in."""
    import itertools

    per = sum(tensor_bytes(t) for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(-(-2 * L2_BYTES // per))]
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def rel_err(got, want):
    import torch

    wide = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    got, want = got.cpu().to(wide), want.cpu().to(wide)
    denom = torch.linalg.vector_norm(want).item()
    diff = torch.linalg.vector_norm(got - want).item()
    return diff / (denom if denom else 1.0), (got - want).abs().max().item()


def bound(nbytes, flops, flops_per_s=FP64_FLOPS_PER_S):
    """``(bound_ms, bound_by)`` for a kernel that must move ``nbytes`` and
    do ``flops`` (at ``flops_per_s``: float64's rate unless given)."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / flops_per_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ell_bytes(op, nb):
    """Bytes an ELL product with ``nb`` columns must move: the matrix's
    nonzeros and their int32 ids once (not the padded slots), x and y."""
    item = op.data.element_size()
    n_rows, n_cols = op.shape
    return op.nnz * (item + 4) + nb * (n_rows + n_cols) * item


def ell_plain(data, cols, X):
    """The ELL plain version a few columns at a time, so that its (b,
    n_rows, L) intermediate stays under 2 GB at the widest b."""
    import torch

    from arnoldi_tpu_torch.ops.kernels import spmv_ell

    if X.ndim == 1:
        return spmv_ell.ell_matvec_plain(data, cols, X)
    step = max(1, 2**31 // (data.numel() * data.element_size()))
    return torch.cat([spmv_ell.ell_matvec_plain(data, cols, X[j:j + step])
                      for j in range(0, X.shape[0], step)])


def ell_columns_single(label, data, cols, X, Y):
    """Fail unless every column of the b-column product ``Y`` equals the
    single-column kernel's result on that column, bit for bit."""
    import torch

    from arnoldi_tpu_torch.ops.kernels import spmv_ell

    for j in range(X.shape[0]):
        if not torch.equal(Y[j], spmv_ell.ell_matvec(data, cols, X[j])):
            fail(f"{label}: column {j} differs from the single-column kernel")


def kernels_in_calls(fn, name, reps=10):
    """The device kernels whose name holds ``name`` that the profiler saw
    over ``reps`` calls of ``fn`` (retried twice when it saw none).  The
    profiler on the H100 has missed device events, so a count below
    ``reps`` still bounds the kernels a call by one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        n = sum(1 for ev in prof.events()
                if ev.device_type == DeviceType.CUDA and name in ev.name)
        if n:
            return n
    return 0


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
    """``A`` as a torch BSR tensor with (8, 8) blocks and int32 indices
    (cuSPARSE multiplies it on the card in every dtype of the port)."""
    import numpy as np
    import torch

    B = A.tobsr(blocksize=(8, 8))
    return torch.sparse_bsr_tensor(
        torch.from_numpy(B.indptr.astype(np.int32)).to(device),
        torch.from_numpy(B.indices.astype(np.int32)).to(device),
        torch.from_numpy(B.data).to(device=device, dtype=dtype), size=B.shape)


class KernelRecord:
    """Errors, times and bound of one kernel over the phase-1 cases, in one
    dtype (``dtype``: float64, the main path's, unless given)."""

    def __init__(self, dtype=None):
        import torch

        self.dtype = torch.float64 if dtype is None else dtype
        self.max_abs_err = 0.0      # cases in self.dtype
        self.ms = None
        self.dev_ms = None          # profiler device time a call
        self.plain_ms = None
        self.bound_ms = None
        self.bound_by = None
        self.library_ms = None      # one PyTorch call computing the same function
        self.library_dev_ms = None  # that call's profiler device time
        self.library = "none"       # that call, or why there is none
        self.enqueue_us = None      # host time a call takes to issue
        self.library_enqueue_us = None
        self.library_enqueue = False

    def time(self, kernel, plain, cold_kernel=None, library_enqueue=False):
        """Time the kernel (CUDA events; profiler device time, of
        ``cold_kernel`` where given: the kernel over ``cold`` copies; the
        host time a call takes to issue) and its plain version;
        ``library_enqueue``: ``time_library`` takes its call's enqueue time
        too (the DIA records)."""
        self.ms = cuda_ms(kernel)
        self.dev_ms = device_ms(kernel if cold_kernel is None else cold_kernel)
        self.plain_ms = cuda_ms(plain)
        self.enqueue_us = enqueue_us(kernel)
        self.library_enqueue = library_enqueue

    def set_bound(self, nbytes, flops):
        import torch

        rate = (FP32_FLOPS_PER_S if self.dtype in (torch.float32, torch.complex64)
                else FP64_FLOPS_PER_S)
        self.bound_ms, self.bound_by = bound(nbytes, flops, rate)
        if self.dev_ms is not None and self.dev_ms < self.bound_ms:
            # No kernel beats its bound: such a time read part of the
            # inputs from L2, so it says nothing of the kernel.
            print(f"  device time {self.dev_ms:.4f} ms under the bound "
                  f"{self.bound_ms:.4f} ms: not kept")
            self.dev_ms = None

    def time_library(self, label, fn, want, cold_fn=None):
        """Time ``fn`` (one PyTorch call, operands built beforehand) as this
        kernel's yardstick, by CUDA events and by the profiler's device time
        (of ``cold_fn`` where given, as the kernel's was taken; and its
        enqueue time where the kernel's was taken), after checking it
        computes the same values."""
        rel, _ = rel_err(fn(), want)
        self.library, self.library_ms = label, cuda_ms(fn)
        self.library_dev_ms = device_ms(fn if cold_fn is None else cold_fn)
        if self.library_enqueue:
            self.library_enqueue_us = enqueue_us(fn)
        dev = ("device not measured" if self.library_dev_ms is None
               else f"device {self.library_dev_ms:.4f} ms")
        print(f"  library {label}: {self.library_ms:.4f} ms, {dev} (rel err "
              f"against the plain version {rel:.1e})")

    def check(self, label, dtype, got, want):
        import torch

        rel, abs_err = rel_err(got, want)
        limit = F64_LIMIT if dtype in (torch.float64, torch.complex128) else F32_LIMIT
        print(f"  {label:<44} {str(dtype):<14} rel {rel:.3e}  "
              f"max_abs {abs_err:.3e}  (limit {limit:g})")
        if not rel <= limit:
            fail(f"{label} {dtype}: relative error {rel:.3e} > {limit:g}")
        if dtype == self.dtype:
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

            def kernel(bands=op.bands, x=x):
                return spmv_banded.banded_matvec(bands, x, op.offsets)

            def library(A, x=x):
                return A @ x

            r.time(kernel,
                   lambda: spmv_banded.banded_matvec_plain(op.bands, x, op.offsets),
                   cold(kernel, op.bands, x), library_enqueue=True)
            n = op.shape[0]
            r.set_bound(op.bands.numel() * 8 + 2 * n * 8, 2 * op.bands.numel())
            A_csr = csr_tensor(mats["laplace"], dtype, dev)
            r.time_library("A_csr @ x (cuSPARSE SpMV)", lambda: library(A_csr),
                           spmv_banded.banded_matvec_plain(op.bands, x, op.offsets),
                           cold(library, A_csr, x))
            del A_csr

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

    # gmres's Gram-Schmidt (solves Z and the sigma svds) runs both passes on
    # its (restart + 1, 2^20) basis; rows past n_active hold an earlier
    # cycle's vectors, NaN here.  Descending n_active, so each NaN fill
    # keeps the rows the next case reads.
    dtype, n_g = torch.float64, mats["scattered"].shape[0]
    Vt = torch.randn(mp1, n_g, generator=gen, device=dev, dtype=dtype) / np.sqrt(n_g)
    w = torch.randn(n_g, generator=gen, device=dev, dtype=dtype)
    for na in (80, 40, 1):
        Vt[na:] = float("nan")
        c = ortho_fused.masked_project(Vt, w, na)
        c_plain = ortho_fused.masked_project_plain(Vt, w, na)
        rec["masked_project"].check(
            f"masked_project gmres basis (81, {n_g}) n_active={na}", dtype, c, c_plain)
        if not bool((c[na:] == 0).all()):
            fail("masked_project: nonzero coefficient past n_active (gmres basis)")
        w2, ns = ortho_fused.project_update_norm(Vt, w, c_plain, na)
        w2p, nsp = ortho_fused.project_update_norm_plain(Vt, w, c_plain, na)
        rec["project_update_norm"].check(
            f"project_update_norm gmres basis w' n_active={na}", dtype, w2, w2p)
        rec["project_update_norm"].check(
            f"project_update_norm gmres basis ||w'||^2 n_active={na}", dtype,
            ns.reshape(1), nsp.reshape(1))
    del Vt, w, w2, w2p

    # The pencil's lumped mass matrix: one band (solve 30's M, inside every
    # CG iteration, and its M-normalization's 5 columns).
    mass = BandedOperator.from_scipy(mats["mass"], device=dev)
    x = torch.randn(mass.shape[0], generator=gen, device=dev, dtype=torch.float64)
    rec["spmv_dia"].check(
        f"DIA lumped mass ({mass.bands.shape[0]}, {mass.shape[0]})", torch.float64,
        spmv_banded.banded_matvec(mass.bands, x, mass.offsets),
        spmv_banded.banded_matvec_plain(mass.bands, x, mass.offsets))
    X5 = torch.randn(5, mass.shape[0], generator=gen, device=dev, dtype=torch.float64)
    rec["spmv_dia_cols"].check(
        f"DIA lumped mass ({mass.bands.shape[0]}, {mass.shape[0]}) b=5", torch.float64,
        spmv_banded.banded_matmat(mass.bands, X5, mass.offsets),
        spmv_banded.banded_matvec_plain(mass.bands, X5, mass.offsets))
    del mass, x, X5
    sync()
    phase_kernels_cols_and_bsr(mats, rec, gen)
    sync()
    phase_ell_edges(mats, rec, gen)
    sync()
    phase_window_edges(rec, gen)
    sync()
    phase_gather_edges(rec, gen)
    sync()
    for name, r in rec.items():
        if name not in ("spmv_dia_ext", "spmv_dia_ext_cols"):   # phase 40's
            print_time(name, r)
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
            r.time(kernel, plain, library_enqueue=name.startswith("spmv_dia"))
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
# 11, 67: a group's ragged end; 327: six column groups (the filter's b = s)
ELL_EDGE_NB = (1, 3, 8, 11, 67, 327)
ELL_EDGE_SHAPE = (100_003, 70_001)          # rows (not a multiple of a tile), columns


def phase_ell_edges(mats, rec, gen):
    """Phase 1, ELL edge shapes: random rectangular ELL operators of
    ELL_EDGE_SHAPE (a row count that is not a multiple of the 32- or 64-row
    tile) at each row length in ELL_EDGE_L, b in ELL_EDGE_NB, float64 and float32,
    plus views one row in (not 16-byte aligned: the element-wise staging
    copies), each against the plain version and every column of the
    b-column form bit for bit against the single-column kernel; then the
    symmetrized matrix S
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
                                           ell_plain(data, cols, X))
                ell_columns_single(f"spmv_ell_cols L={L} b={nb} {dtype}", data,
                                   cols, X, Y)
                del Y, X
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
          max_restarts=1000, dtype=None, device=None, tol=1e-8, v0=None):
    """One partial_schur solve on the card (in ``dtype``, default float64);
    returns (Q, T, hist, wall)."""
    import torch

    from arnoldi_tpu_torch import partial_schur

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q, T, hist = partial_schur(op, nev, max_dim=max_dim, stopping_criterion=tol,
                               sort_function=which,
                               dtype=dtype or torch.float64, ortho="cgs2",
                               max_restarts=max_restarts,
                               block_size=block_size, p=p, device=device, v0=v0)
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


def host_array(t):
    """A tensor as a float64 (complex128 for a complex one) host array."""
    import numpy as np

    a = t.cpu().numpy()
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def eigh_residual(label, A, vals, V):
    """Residual ||Av - lambda v|| / max|lambda| and orthonormality of V."""
    import numpy as np

    Vh = host_array(V)
    res = np.linalg.norm(A @ Vh - Vh * vals[None, :], axis=0) / np.abs(vals).max()
    orth = np.abs(Vh.conj().T @ Vh - np.eye(len(vals))).max()
    print(f"  eigenvalues {vals}")
    print(f"  residual / max|lambda| {res.max():.3e} (limit 1e-7); "
          f"|V^H V - I| {orth:.3e} (limit 1e-10)")
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

    Qh, Th = host_array(Q), host_array(T)
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
    # ARPACK at tol 1e-12: at 1e-8 its own error on mark(100)'s clustered
    # values ranged from 1.7e-10 to 1.25e-9 with its start vector (SciPy
    # 1.18 on an H100 host), where this solve's is 1.1e-10.
    check_arpack("solve L, mark(100)", A, Q, T,
                 eigs(A, 5, which="LR", tol=1e-12, ncv=40,
                      return_eigenvectors=False))
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
    # The raw trace: torch's FunctionEvent list (prof.events()) took 100 s
    # to build for solve X's ~0.5M kernels on the card machine.
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
    total = sum(by_name.values())
    busy = total / 1e3 / wall if wall else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {label} under the profiler: wall {wall:.4f} s, device {total:.3f} ms "
          f"(busy {100 * busy:.1f} %; reading the trace took "
          f"{time.perf_counter() - t0 - wall:.2f} s); by kernel (ms): "
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
    refs["O_svds"] = ref      # the sigma svds of phase 29 is held against it
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


COMPLEX_KERNELS = ("spmv_dia", "spmv_dia_cols", "spmv_ell", "spmv_ell_cols",
                   "masked_project", "project_update_norm")
#: The complex forms each complex dtype's solves must launch (phases 19-25).
COMPLEX_PATH = {"complex128": COMPLEX_KERNELS,
                "complex64": ("spmv_ell", "masked_project", "project_update_norm")}
GAUGE_PHASE = 0.5235987755982988      # pi / 6


def scattered_matrix(n):
    """The scattered test matrix (solves B, C, F, G, M, P; phased, R-V)."""
    from arnoldi_tpu_torch import matrices

    return matrices.random_scattered(n, 24, seed=1, bandwidth=min(2**14, n // 4),
                                     block=8)


def gauge_rotated(A, seed=5, phase=GAUGE_PHASE):
    """``(e^{i phase} G A G^H, g)`` with ``G = diag(g)``, ``g = e^{i theta}``
    and theta uniform on [0, 2 pi) from ``seed``: complex, with A's stencil
    (so DIA) and, A being normal, A's eigenvalues times ``e^{i phase}``."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    g = np.exp(1j * rng.uniform(0, 2 * np.pi, A.shape[0]))
    G = sp.diags(g)
    return (np.exp(1j * phase) * (G @ A @ G.conj().T)).tocsr(), g


def phased(A, seed=7):
    """A with every off-diagonal value times ``e^{i phi}`` (phi uniform on
    [0, 2 pi) from ``seed``) and its diagonal kept: complex, non-normal, the
    same sparsity (so the same ELL layout)."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    C = sp.coo_matrix(A).astype(np.complex128)
    off = C.row != C.col
    C.data[off] *= np.exp(1j * rng.uniform(0, 2 * np.pi, int(off.sum())))
    return C.tocsr()


def hermitian_part(A):
    return ((A + A.conj().T) / 2).tocsr()


def complex_reference(kind, n):
    """ARPACK's values for a complex solve at ``n`` rows, with the seconds
    it took: "R" the five largest-real eigenvalues of the phased scattered
    matrix, "T" the five largest of the Hermitian part of the phased
    reflected one, "svds" the five largest singular values of the latter;
    for solve Z, "Z" the ten largest-real eigenvalues of the (real)
    scattered matrix; for solve DB, "DB" the five largest-real eigenvalues
    of the phased banded-1024 matrix, "svds_db" its five largest singular
    values and "svds_bsr" those of its reflected form (phase 38); for
    phase 42, "E9" the five largest eigenvalues of ``separated_banded``.
    Run in a worker process (``start_references``): each builds its matrix
    from the seeds the solves use."""
    import numpy as np
    from scipy.sparse.linalg import eigs, eigsh
    from scipy.sparse.linalg import svds as scipy_svds

    t0 = time.perf_counter()
    if kind == "R":
        ref = eigs(phased(scattered_matrix(n)), 5, which="LR", tol=1e-8, ncv=40,
                   return_eigenvectors=False)
    elif kind == "T":
        ref = eigsh(hermitian_part(phased(reflected_scattered(n))), 5, which="LA",
                    tol=1e-8, ncv=40, return_eigenvectors=False)
    elif kind == "Z":
        ref = eigs(scattered_matrix(n), 10, which="LR", tol=1e-8, ncv=40,
                   return_eigenvectors=False)
    elif kind == "DB":
        ref = eigs(phased(window_matrix(n)), 5, which="LR", tol=1e-8, ncv=40,
                   return_eigenvectors=False)
    elif kind == "svds_bsr":
        ref = np.sort(scipy_svds(phased(reflected_scattered(n, seed=2, bandwidth=1024)),
                                 5, solver="arpack", tol=1e-10,
                                 return_singular_vectors=False))
    elif kind == "E9":
        ref = eigsh(separated_banded(n), 5, which="LA", tol=1e-10, ncv=20,
                    return_eigenvectors=False)
    elif kind == "svds_db":
        ref = np.sort(scipy_svds(phased(window_matrix(n)), 5, solver="arpack",
                                 tol=1e-10, return_singular_vectors=False))
    else:
        ref = np.sort(scipy_svds(phased(reflected_scattered(n)), 5, solver="arpack",
                                 tol=1e-10, return_singular_vectors=False))
    return ref, time.perf_counter() - t0


def pencil_reference(side, sigma=0.01):
    """The five eigenvalues of the pencil (``laplace_2d(side)``,
    ``lumped_mass``) nearest ``sigma``, with the seconds it took: ARPACK
    shift-invert on the equivalent standard problem ``M^-1/2 A M^-1/2`` (M
    diagonal), its shifted matrix factorized by SuperLU in the
    ``MMD_AT_PLUS_A`` ordering (the structure is symmetric).  Run in the
    worker process (``start_references``)."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.linalg import LinearOperator, eigsh, splu

    from arnoldi_tpu_torch import matrices

    t0 = time.perf_counter()
    A = matrices.laplace_2d(side)
    n = A.shape[0]
    D = sp.diags(1.0 / np.sqrt(lumped_mass(n).diagonal()))
    C = (D @ A @ D).tocsc()
    lu = splu((C - sigma * sp.identity(n, format="csc")).tocsc(),
              permc_spec="MMD_AT_PLUS_A")
    inv = LinearOperator((n, n), matvec=lu.solve, dtype=np.float64)
    ref = np.sort(eigsh(C, 5, sigma=sigma, which="LM", OPinv=inv, tol=1e-12,
                        return_eigenvectors=False))
    return ref, time.perf_counter() - t0


def _one_blas_thread():
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def start_references(n, side):
    """Start the complex solves' ARPACK references (``complex_reference``,
    ``n`` rows) and the pencil's (``pencil_reference``, ``laplace_2d(side)``)
    in one worker process with one BLAS thread, so that they run on the
    host while phases 1-18 run on the card.  Returns ``(pool, {kind:
    async result})``; the caller closes the pool, or terminates it on a
    failure."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1, initializer=_one_blas_thread)
    references = {kind: pool.apply_async(complex_reference, (kind, n))
                  for kind in ("R", "T", "svds", "Z", "DB", "svds_db",
                               "svds_bsr", "E9")}
    references["pencil"] = pool.apply_async(pencil_reference, (side,))
    return pool, references


def reference(references, kind):
    ref, seconds = references[kind].get()
    print(f"  ARPACK reference {kind} (host, worker process) took {seconds:.2f} s")
    return ref


def kernel_names(fn):
    """The device kernels one call of ``fn`` runs (profiler), to show
    whether a library call materializes an operand (a conjugate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sorted({short(ev.name) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA})


def phase_complex_kernels(mats, gen, device="cuda"):
    """Phase 1, complex forms: DIA (b = 1, 8) on the gauge-rotated
    laplace_2d(724) of solve Q, ELL (b = 1, 8) on the phased scattered
    matrix of solves R-V (the staged path, L = 25) and on solve T's
    Hermitian matrix (the warp path, L = 129), and the two CGS2 passes on a
    (81, 524176) basis (n_active 0, 1, 40, 80, stale rows NaN), in
    complex128 and complex64, each against its plain version (1e-12 and
    1e-5), every column of a b-column form bit for bit against the
    single-column kernel; then each timed at the main path's shapes beside
    its bound (bytes at 3.35 TB/s; 8 flops a complex multiply-add) and its
    library call.  Returns ``{(kernel, dtype name): KernelRecord}``.
    ``device="cpu"`` rehearses it with the plain versions (stub the
    timers)."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch.linop import BandedOperator, EllOperator, cast_operator
    from arnoldi_tpu_torch.ops.kernels import ortho_fused, spmv_banded, spmv_ell

    dev = torch.device(device)
    dia0 = BandedOperator.from_scipy(mats["gauge"], device=dev)
    ell0 = EllOperator.from_scipy(mats["phased"], device=dev)
    herm0 = EllOperator.from_scipy(mats["hermitian"], device=dev)
    crec = {}
    for dtype in (torch.complex128, torch.complex64):
        tag = str(dtype).removeprefix("torch.")
        rec = {name: KernelRecord(dtype) for name in COMPLEX_KERNELS}
        crec.update({(name, tag): r for name, r in rec.items()})
        item = torch.empty((), dtype=dtype).element_size()

        op = cast_operator(dia0, dtype)
        n = op.shape[0]
        X = torch.randn(B_COLS, n, generator=gen, device=dev, dtype=dtype)
        A_csr = csr_tensor(mats["gauge"], dtype, dev)
        for name, arg, nb in (("spmv_dia", X[0].contiguous(), 1),
                              ("spmv_dia_cols", X, B_COLS)):
            fn = spmv_banded.banded_matvec if nb == 1 else spmv_banded.banded_matmat
            r = rec[name]

            def kernel(bands=op.bands, arg=arg, fn=fn):
                return fn(bands, arg, op.offsets)

            def plain(arg=arg):
                return spmv_banded.banded_matvec_plain(op.bands, arg, op.offsets)

            rhs = arg if nb == 1 else arg.T.contiguous()

            def library(A=A_csr, rhs=rhs):
                return A @ rhs

            r.check(f"DIA gauge laplace_2d(724) b={nb}", dtype, kernel(), plain())
            r.time(kernel, plain, cold(kernel, op.bands, arg), library_enqueue=True)
            r.set_bound(op.bands.numel() * item + 2 * nb * n * item,
                        8 * op.bands.numel() * nb)
            r.time_library(f"A_csr @ {'x' if nb == 1 else 'Xt'} (cuSPARSE "
                           f"{'SpMV' if nb == 1 else 'SpMM'}, {tag})",
                           library, plain() if nb == 1 else plain().T,
                           cold(library, A_csr, rhs))
        if not torch.equal(spmv_banded.banded_matmat(op.bands, X, op.offsets)[3],
                           spmv_banded.banded_matvec(op.bands, X[3].contiguous(),
                                                     op.offsets)):
            fail(f"spmv_dia_cols {tag}: a column differs from the single-column kernel")
        del op, X, A_csr

        op = cast_operator(ell0, dtype)
        X = torch.randn(B_COLS, op.shape[1], generator=gen, device=dev, dtype=dtype)
        A_csr = csr_tensor(mats["phased"], dtype, dev)
        for name, arg, nb in (("spmv_ell", X[0].contiguous(), 1),
                              ("spmv_ell_cols", X, B_COLS)):
            fn = spmv_ell.ell_matvec if nb == 1 else spmv_ell.ell_matmat
            r = rec[name]

            def kernel(fn=fn, arg=arg):
                return fn(op.data, op.cols, arg)

            def plain(arg=arg):
                return spmv_ell.ell_matvec_plain(op.data, op.cols, arg)

            r.check(f"ELL phased scattered 2^20 (L={op.data.shape[1]}) b={nb}",
                    dtype, kernel(), plain())
            r.time(kernel, plain)
            r.set_bound(ell_bytes(op, nb), 8 * op.nnz * nb)
            rhs = arg if nb == 1 else arg.T.contiguous()
            r.time_library(f"A_csr @ {'x' if nb == 1 else 'Xt'} (cuSPARSE "
                           f"{'SpMV' if nb == 1 else 'SpMM'}, {tag})",
                           lambda rhs=rhs: A_csr @ rhs,
                           plain() if nb == 1 else plain().T)
        if not torch.equal(spmv_ell.ell_matmat(op.data, op.cols, X)[5],
                           spmv_ell.ell_matvec(op.data, op.cols, X[5].contiguous())):
            fail(f"spmv_ell_cols {tag}: a column differs from the single-column kernel")
        del op, X, A_csr
        # b = 3 here: the plain version's gather of 8 columns at L = 129
        # would take 17 GB in complex128, twice.
        op = cast_operator(herm0, dtype)
        X = torch.randn(3, op.shape[1], generator=gen, device=dev, dtype=dtype)
        label = f"ELL T's Hermitian matrix (L={op.data.shape[1]})"
        rec["spmv_ell"].check(label, dtype, spmv_ell.ell_matvec(op.data, op.cols, X[0]),
                              spmv_ell.ell_matvec_plain(op.data, op.cols, X[0]))
        Y = spmv_ell.ell_matmat(op.data, op.cols, X)
        rec["spmv_ell_cols"].check(f"{label} b=3", dtype, Y,
                                   spmv_ell.ell_matvec_plain(op.data, op.cols, X))
        if not torch.equal(Y[2], spmv_ell.ell_matvec(op.data, op.cols, X[2].contiguous())):
            fail(f"spmv_ell_cols {tag} L={op.data.shape[1]}: a column differs from "
                 "the single-column kernel")
        del op, X, Y

        n, mp1 = mats["gauge"].shape[0], 81
        Vt = torch.randn(mp1, n, generator=gen, device=dev, dtype=dtype) / np.sqrt(n)
        w = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        for na in (0, 1, 40, 80):
            Vs = Vt.clone()
            Vs[na:] = float("nan")
            c = ortho_fused.masked_project(Vs, w, na)
            c_plain = ortho_fused.masked_project_plain(Vs, w, na)
            rec["masked_project"].check(f"masked_project Vt (81, {n}) n_active={na}",
                                        dtype, c, c_plain)
            if not bool((c[na:] == 0).all()):
                fail(f"masked_project {tag}: nonzero coefficient past n_active")
            w2, ns = ortho_fused.project_update_norm(Vs, w, c_plain, na)
            w2p, nsp = ortho_fused.project_update_norm_plain(Vs, w, c_plain, na)
            if ns.dtype != dtype.to_real():
                fail(f"project_update_norm {tag}: a {ns.dtype} norm")
            rec["project_update_norm"].check(f"project_update_norm w' n_active={na}",
                                             dtype, w2, w2p)
            rec["project_update_norm"].check(
                f"project_update_norm ||w'||^2 n_active={na}", dtype,
                ns.reshape(1), nsp.reshape(1))
        r = rec["masked_project"]
        r.time(lambda: ortho_fused.masked_project(Vs, w, na),
               lambda: ortho_fused.masked_project_plain(Vs, w, na))
        r.set_bound((na * n + n + na) * item, 8 * na * n)
        Va = Vs[:na]
        names = kernel_names(lambda: Va.conj() @ w)
        r.time_library(f"Vt[:k].conj() @ w (cuBLAS; device kernels {names})",
                       lambda: Va.conj() @ w, c_plain[:na])
        r = rec["project_update_norm"]
        r.time(lambda: ortho_fused.project_update_norm(Vs, w, c_plain, na),
               lambda: ortho_fused.project_update_norm_plain(Vs, w, c_plain, na))
        r.set_bound((na * n + 2 * n + na) * item + item // 2, 8 * na * n + 4 * n)
        ca = c_plain[:na]
        partial = cuda_ms(lambda: torch.addmv(w, Va.T, ca, alpha=-1))
        r.library = (f"none (torch.addmv(w, Vt[:k].T, c, alpha=-1), the update "
                     f"without the norm: {partial:.4f} ms)")
        print(f"  library for project_update_norm {tag}: {r.library}")
        del Vt, Vs, Va, ca, w
        sync()
        for name, r in rec.items():
            print_time(f"{name}:{tag}", r)
    return crec


def print_time(name, r):
    """One kernel's times beside its bound and library call: the share of
    the bound against the event time and the device time (they differ where
    the host paces the launches)."""
    lib = "none" if r.library_ms is None else f"{r.library_ms:.4f} ms"
    if r.library_dev_ms is not None:
        lib += f" (device {r.library_dev_ms:.4f} ms)"
    dev = ("device not measured" if r.dev_ms is None else
           f"device {r.dev_ms:.4f} ms, {100 * r.bound_ms / r.dev_ms:.0f} %")
    if r.enqueue_us is not None:
        dev += f", enqueue {r.enqueue_us:.2f} us"
    if r.library_enqueue_us is not None:
        lib += f" (enqueue {r.library_enqueue_us:.2f} us)"
    print(f"  time {name:<28} kernel {r.ms:.4f} ms   plain {r.plain_ms:.4f} ms   "
          f"bound {r.bound_ms:.4f} ms ({r.bound_by}; {100 * r.bound_ms / r.ms:.0f} %; "
          f"{dev})   library {lib}: {r.library}")


def check_launched_dtype(label, before, after, names, dtype):
    """Fail unless each kernel in ``names`` launched in ``dtype`` between the
    two ``dtype_launch_counts()`` readings."""
    tag = str(dtype).removeprefix("torch.")
    for name in names:
        if after[name].get(tag, 0) == before[name].get(tag, 0):
            fail(f"{label} did not launch {name} in {tag}")


def check_triangular(label, T):
    import numpy as np

    Th = host_array(T)
    below = float(np.abs(np.tril(Th, -1)).max()) if Th.shape[0] > 1 else 0.0
    if below != 0.0:
        fail(f"{label}: the complex Schur form is not upper triangular ({below:.3e})")


def check_rotated_laplace(label, A, Q, T, side):
    """Hold a solve of the gauge-rotated laplace_2d(side) against its exact
    spectrum, ``e^{i pi/6}`` times laplace_2d_eigen(side): each value within
    1e-9 of its nearest exact eigenvalue, the largest magnitude found, a
    Schur residual within 1e-7 and an upper triangular T."""
    import numpy as np

    from arnoldi_tpu_torch import matrices

    res, lam = schur_residual(A, Q, T)
    check_triangular(label, T)
    exact = np.exp(1j * GAUGE_PHASE) * matrices.laplace_2d_eigen(side)
    err = np.abs(lam[:, None] - exact[None, :]).min(axis=1).max()
    top_err = abs(np.abs(lam).max() - np.abs(exact).max())
    print(f"  eigenvalues / e^(i pi/6) {np.sort((lam * np.exp(-1j * GAUGE_PHASE)).real)}")
    print(f"  Schur residual / max|lambda| {res.max():.3e} (limit 1e-7); "
          f"eigenvalue error {err:.3e} (limit 1e-9); max|lambda| error "
          f"{top_err:.3e} (limit 1e-9)")
    if not (res.max() <= 1e-7 and err <= 1e-9 and top_err <= 1e-9):
        fail(f"{label} disagrees with the rotated analytic spectrum")


def matched_error(lam, ref):
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(np.asarray(lam)[:, None] - np.asarray(ref)[None, :])
    ri, ci = linear_sum_assignment(cost)
    return float(cost[ri, ci].max())


def phase_complex(mats, references, counts, dcounts, refs, device="cuda"):
    """Phases 19-25, the complex path: solves Q (DIA), R and U (ELL, scalar
    and block-8, and block-8 DIA), V (complex64), T (complex Hermitian
    ``partial_eigh``), W (the complex128 host tier) and ``svds`` of a
    complex matrix.  ``references``: the ARPACK references
    (``start_references``), ``refs``: solve A's matvecs.  Q, R and T run
    once more under the profiler (``device_split``, with
    ``device="cuda"``).  Returns ``([(label, history, wall), ...], {label:
    {summary field: value}})``."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator, partial_schur, svds
    from arnoldi_tpu_torch.solvers.svd import gram_companions
    from arnoldi_tpu_torch.utils.random import rand_normalized_vector

    c128, c64 = torch.complex128, torch.complex64
    rows, extra = [], {}
    profiled = device_split if torch.device(device).type == "cuda" else (
        lambda label, run: {})

    A = mats["gauge"]
    side = round(A.shape[0] ** 0.5)
    print(f"phase 19: solve Q, the gauge-rotated laplace_2d({side}), complex128, "
          "LM, k=5, m=80, v0 = G v0_A")
    op = as_operator(A, device=device)
    if type(op).__name__ != "BandedOperator" or op.dtype != c128:
        fail(f"solve Q: a {op.dtype} {type(op).__name__}, not a complex128 DIA operator")
    # solve A's start vector (the default generator's draw), rotated by G:
    # the Krylov space is the unitary image of solve A's.
    v0 = torch.from_numpy(mats["gauge_g"]) * rand_normalized_vector(
        A.shape[0], torch.float64, device="cpu")

    def run_q():
        return solve("solve Q", op, 5, "LM", 80, counts, dtype=c128, v0=v0,
                      max_restarts=5000)

    before = dcounts()
    Q, T, hist_q, wall_q = run_q()
    check_launched_dtype("solve Q", before, dcounts(),
                         ("spmv_dia", "masked_project", "project_update_norm"), c128)
    check_rotated_laplace("solve Q", A, Q, T, side)
    print(f"  matvecs: solve Q {hist_q.total_matvecs}, solve A {refs['A_matvecs']}")
    rows.append(("Q", hist_q, wall_q))
    del Q
    extra["Q"] = profiled("solve Q", run_q)
    del op

    A = mats["phased"]
    print("phase 20: solve R, the phased scattered matrix (ELL, complex128), LR, "
          "k=5, m=40")
    op_r = as_operator(A, device=device)
    if type(op_r).__name__ != "EllOperator" or op_r.dtype != c128:
        fail(f"solve R: a {op_r.dtype} {type(op_r).__name__}, not a complex128 ELL operator")
    print(f"  operator EllOperator L={op_r.data.shape[1]} nnz={op_r.nnz}")

    def run_r():
        return solve("solve R", op_r, 5, "LR", 40, counts, dtype=c128)

    before = dcounts()
    Q, T, hist_r, wall_r = run_r()
    check_launched_dtype("solve R", before, dcounts(),
                         ("spmv_ell", "masked_project", "project_update_norm"), c128)
    check_triangular("solve R", T)
    ref_r = reference(references, "R")
    check_arpack("solve R", A, Q, T, ref_r)
    lam_r = np.diag(host_array(T))
    rows.append(("R", hist_r, wall_r))
    del Q
    extra["R"] = profiled("solve R", run_r)

    print(f"phase 21: solve U, R's operator with block_size={B_COLS}; the "
          f"gauge-rotated laplace_2d(200), block_size={B_COLS}, LM, k=5, m=80, p=40")
    before = dcounts()
    Q, T, hist_u, wall_u = solve("solve U", op_r, 5, "LR", 40, counts, dtype=c128,
                                 block_size=B_COLS)
    check_launched_dtype("solve U", before, dcounts(), ("spmv_ell_cols",), c128)
    check_triangular("solve U", T)
    check_arpack("solve U", A, Q, T, ref_r)
    rows.append(("U", hist_u, wall_u))
    del Q
    A200 = mats["gauge200"]
    op = as_operator(A200, device=device)
    before = dcounts()
    Q, T, hist_u2, wall_u2 = solve("solve U, gauge laplace_2d(200)", op, 5, "LM", 80,
                                   counts, dtype=c128, block_size=B_COLS, p=40,
                                   max_restarts=5000)
    check_launched_dtype("solve U (DIA)", before, dcounts(), ("spmv_dia_cols",), c128)
    check_rotated_laplace("solve U (DIA)", A200, Q, T, round(A200.shape[0] ** 0.5))
    rows.append(("U_gauge200", hist_u2, wall_u2))
    del Q, op

    print("phase 22: solve V, R's operator in complex64, tol 1e-5, LR, k=5, m=40")
    before = dcounts()
    Q, T, hist_v, wall_v = solve("solve V", op_r, 5, "LR", 40, counts, dtype=c64,
                                 tol=1e-5)
    check_launched_dtype("solve V", before, dcounts(),
                         ("spmv_ell", "masked_project", "project_update_norm"), c64)
    if Q.dtype != c64 or "refine.continue" in hist_v.phases:
        fail(f"solve V: a {Q.dtype} result, or a refined one")
    check_triangular("solve V", T)
    err = matched_error(np.diag(host_array(T)), lam_r)
    print(f"  eigenvalues {np.sort_complex(np.diag(host_array(T)))}; matched "
          f"error against solve R {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        fail("solve V disagrees with solve R")
    rows.append(("V", hist_v, wall_v))
    del Q, op_r

    H = mats["hermitian"]
    print("phase 23: solve T, partial_eigh of the Hermitian part of the phased "
          "reflected matrix (ELL, complex128), LA, k=5, m=40, device loop")
    op_t = as_operator(H, device=device)
    if type(op_t).__name__ != "EllOperator" or op_t.data.shape[1] <= 32:
        fail("solve T: the Hermitian matrix should route to ELL's warp path (L > 32)")
    print(f"  operator EllOperator L={op_t.data.shape[1]} nnz={op_t.nnz}")

    def run_t():
        return eigh_solve("solve T", op_t, 5, 40, counts, dtype=c128)

    before = dcounts()
    vals, V, hist_t, wall_t = run_t()
    check_launched_dtype("solve T", before, dcounts(),
                         ("spmv_ell", "masked_project", "project_update_norm"), c128)
    if "trl.device_loop" not in hist_t.phases or V.dtype != c128:
        fail("solve T did not run the device loop in complex128")
    check_eigsh("solve T", H, vals, V, reference(references, "T"))
    rows.append(("T", hist_t, wall_t))
    del V
    extra["T"] = profiled("solve T", run_t)
    del op_t

    Aw = mats["mark_phased"]
    print(f"phase 24: solve W, the complex128 host tier: phased mark(100) "
          f"(n = {Aw.shape[0]}) as SciPy input, device='{device}', LR, k=5, m=20")
    before = counts()
    t0 = time.perf_counter()
    Q, T, hist_w = partial_schur(Aw, 5, sort_function="LR", max_dim=20,
                                 stopping_criterion=1e-8, max_restarts=1000,
                                 device=device)
    sync()
    wall_w = time.perf_counter() - t0
    report_solve("solve W", hist_w, wall_w, counts, host_tier=True)
    if counts() != before:
        fail(f"solve W launched kernels: {before} -> {counts()}")
    if (Q.device.type != torch.device(device).type or Q.dtype != c128
            or "host.expand" not in hist_w.phases):
        fail(f"solve W: a {Q.dtype} result on {Q.device}, phases {list(hist_w.phases)}")
    check_triangular("solve W", T)
    from scipy.sparse.linalg import eigs

    # ncv = 40: at ARPACK's default (11) its iteration on this clustered
    # end of the spectrum can settle on a set that skips one of the five
    # largest real parts.
    check_arpack("solve W", Aw, Q, T,      # tol 1e-12: see solve L's reference
                 eigs(Aw, 5, which="LR", tol=1e-12, ncv=40, return_eigenvectors=False))
    rows.append(("W", hist_w, wall_w))
    del Q

    Af = mats["phased_reflect"]
    print("phase 25: svds of the phased reflected matrix (complex128), k=5, LM, "
          "tol 1e-8, m=40: Lanczos on A^H A")
    op = as_operator(Af, device=device)
    companions = gram_companions(Af, op)
    print(f"  A: {type(op).__name__} L={op.data.shape[1]}; A^H: "
          f"{type(companions[0]).__name__} L={companions[0].data.shape[1]}, "
          f"{companions[0].dtype}")
    before = dcounts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    U, s, Vh, hist_x = svds(op, 5, which="LM", tol=1e-8, ncv=40, dtype=c128,
                            companions=companions, return_history=True)
    sync()
    wall_x = time.perf_counter() - t0
    report_solve("complex svds", hist_x, wall_x, counts)
    check_launched_dtype("complex svds", before, dcounts(), ("spmv_ell",), c128)
    ref = reference(references, "svds")
    Uh, Vn = host_array(U), host_array(Vh).conj().T
    sv_err = float(np.abs(s - ref).max() / ref.max())
    r_av = float(np.linalg.norm(Af @ Vn - Uh * s, axis=0).max() / s.max())
    r_ahu = float(np.linalg.norm(Af.conj().T @ Uh - Vn * s, axis=0).max() / s.max())
    orth = max(np.abs(Uh.conj().T @ Uh - np.eye(5)).max(),
               np.abs(Vn.conj().T @ Vn - np.eye(5)).max())
    print(f"  singular values {s}; ARPACK {ref}")
    print(f"  relative error {sv_err:.3e} (limit 1e-9); |Av - su| / s_max "
          f"{r_av:.3e}, |A^H u - sv| / s_max {r_ahu:.3e} (limits 1e-7); "
          f"orthonormality {orth:.3e} (limit 1e-10)")
    if not (U.dtype == c128 and sv_err <= 1e-9 and r_av <= 1e-7 and r_ahu <= 1e-7
            and orth <= 1e-10):
        fail("complex svds disagrees with ARPACK's svds or its triplets are off")
    rows.append(("svds_complex", hist_x, wall_x))
    return rows, extra


#: The kernels each shift-invert solve of phases 26-31 must launch.
SHIFT_INVERT_KERNELS = {
    "X": ("spmv_dia", "masked_project", "project_update_norm"),
    "Y": ("spmv_ell", "masked_project", "project_update_norm"),
    "Z": ("spmv_ell", "masked_project", "project_update_norm"),
    "svds_sigma": ("spmv_ell", "masked_project", "project_update_norm"),
    "pencil": ("spmv_dia", "masked_project", "project_update_norm"),
    "splu": ("masked_project", "project_update_norm"),
}


def lumped_mass(n, seed=9):
    """A diagonal mass matrix ``diag(m)``, m uniform on [0.5, 1.5] from
    ``seed`` (a lumped finite-element mass matrix), as CSR."""
    import numpy as np
    import scipy.sparse as sp

    return sp.diags(np.random.default_rng(seed).uniform(0.5, 1.5, n)).tocsr()


def transform_solve(label, run, counts):
    """Run one ``eigs``/``eigsh``/``svds`` call (``run()``), print its
    wall, outer matvecs, inner solves and matvecs, inner matvecs an outer
    matvec and the kernels it launched, and fail unless it launched those
    of ``SHIFT_INVERT_KERNELS[label]``.  Returns ``(out, hist, wall,
    fields)``."""
    import torch

    from arnoldi_tpu_torch.solvers.spectral_transform import accounting

    torch.cuda.reset_peak_memory_stats()
    before = counts()
    with accounting() as seen:
        t0 = time.perf_counter()
        out = run()
        sync()
        wall = time.perf_counter() - t0
    after = counts()
    hist, stats = seen["hist"][-1], seen["stats"][-1]
    outer_mv = hist.total_matvecs
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    fields = {"outer_matvecs": outer_mv, "inner_solves": stats.solves,
              "inner_matvecs": stats.inner_matvecs,
              "inner_per_outer": stats.inner_matvecs / outer_mv,
              "launches": launched}
    print(f"  solve {label}: wall {wall:.4f} s, outer matvecs {outer_mv}, "
          f"restarts {len(hist.residual_trace)}, inner solves {stats.solves}, "
          f"inner matvecs {stats.inner_matvecs} "
          f"({fields['inner_per_outer']:.1f} an outer matvec), peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"  kernels launched: {launched}")
    check_launched(f"solve {label}", before, after, SHIFT_INVERT_KERNELS[label])
    return out, hist, wall, fields


def check_nearest(label, vals, exact, sigma, k, tol=1e-9):
    """Hold values found nearest ``sigma`` against the exact spectrum: each
    within ``tol`` of an exact eigenvalue, and every distinct value among
    the k exact ones nearest sigma found (a scalar Krylov space may hold one
    copy of a double eigenvalue)."""
    import numpy as np

    err = np.abs(exact[None, :] - vals[:, None]).min(axis=1).max()
    want = exact[np.argsort(np.abs(exact - sigma), kind="stable")[:k]]
    missed = np.abs(want[:, None] - vals[None, :]).min(axis=1).max()
    print(f"  eigenvalues {np.sort(vals)}; the {k} exact nearest sigma "
          f"{np.sort(want)}")
    print(f"  eigenvalue error {err:.3e}, nearest-sigma set error {missed:.3e} "
          f"(limits {tol:g})")
    if not (err <= tol and missed <= tol):
        fail(f"{label} disagrees with the exact values nearest sigma")


def vector_residual(A, vals, V, scale, B=None, hermitian=True):
    """``(res, norm_err, orth_err)``: ``max ||A v - lambda B v|| / (scale
    ||B v||)`` (B = I when None), and for a Hermitian problem the largest
    diagonal and off-diagonal errors of ``V^H B V = I`` (else None).
    ``scale`` is the spectrum's largest magnitude: a shift-invert solve to
    tol 1e-8 has vectors accurate to about tol in the transformed problem,
    so its residual scales with ``||A||``, not with the small values it
    finds (their ratio is printed too; ``PERF.md`` §2)."""
    import numpy as np

    Vh = host_array(V)
    BV = Vh if B is None else B @ Vh
    res = np.linalg.norm(A @ Vh - BV * vals[None, :], axis=0) / np.linalg.norm(BV, axis=0)
    found = float(np.abs(vals).max())
    norm_err = orth_err = None
    line = (f"  residual / (max|lambda| |Bv|) {res.max() / scale:.3e} (limit 1e-7; "
            f"max|lambda| {scale:.6g}); over the largest value found ({found:.6g}) "
            f"{res.max() / found:.3e}")
    if hermitian:
        G = Vh.conj().T @ BV - np.eye(len(vals))
        norm_err = float(np.abs(np.diag(G)).max())
        orth_err = float(np.abs(G - np.diag(np.diag(G))).max())
        line += f"; V^H B V - I: diagonal {norm_err:.3e}, off-diagonal {orth_err:.3e}"
    print(line)
    return res.max() / scale, norm_err, orth_err


def phase_shift_invert(mats, references, counts, refs, device="cuda"):
    """Phases 26-31, shift-invert: solves X (``eigsh`` sigma, cg over DIA),
    Y (``eigs`` sigma, bicgstab over ELL), Z (``eigs`` at an interior
    shift, gmres over ELL), the sigma ``svds`` (gmres over the Gram's two
    ELL legs), the pencil (``eigsh`` with M, cg over DIA) and splu (the
    host LU, the outer solve on the card), all float64 to tol 1e-8 (inner
    tol 1e-10).  ``references``: the ARPACK references
    (``start_references``), ``refs``: solve B's ARPACK values and solve O's
    singular values.  X runs once more under the profiler.  Returns
    ``([(label, history, wall), ...], {label: {summary field: value}})``."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator, eigs, eigsh, matrices, svds
    from arnoldi_tpu_torch.solvers.svd import gram_companions

    rows, extra = [], {}
    profiled = device_split if torch.device(device).type == "cuda" else (
        lambda label, run: {})

    t_phase = [time.perf_counter()]

    def record(label, hist, wall, fields):
        rows.append((label, hist, wall))
        extra[label] = fields
        now = time.perf_counter()
        print(f"  phase wall {now - t_phase[0]:.2f} s (the solve, its checks "
              "and the operator's build)")
        t_phase[0] = now

    A = mats["laplace"]
    side = round(A.shape[0] ** 0.5)
    exact = np.sort(matrices.laplace_2d_eigen(side))
    scale = float(np.abs(exact).max())
    print(f"phase 26: solve X, eigsh(laplace_2d({side}) as DIA, k=5, sigma=0.01, "
          "LM, ncv=40, cg inner solves)")
    op = as_operator(A, dtype=torch.float64, device=device)

    def run_x():
        return eigsh(op, 5, sigma=0.01, which="LM", ncv=40, tol=1e-8,
                     inner_solver="cg")

    (vals, V), hist, wall, fields = transform_solve("X", run_x, counts)
    check_nearest("solve X", vals, exact, 0.01, 5)
    res, norm_err, orth_err = vector_residual(A, vals, V, scale)
    if not (res <= 1e-7 and max(norm_err, orth_err) <= 1e-10):
        fail("solve X: residual or orthonormality out of bounds")
    del V
    fields.update(profiled("solve X", run_x))
    record("X", hist, wall, fields)

    S = mats["scattered"]
    op = as_operator(S, dtype=torch.float64, device=device)
    scale = float(np.abs(refs["B"]).max())
    print("phase 27: solve Y, eigs(the scattered 2^20 matrix as ELL, k=5, "
          "sigma=1.7, ncv=40, bicgstab inner solves)")
    (vals, V), hist, wall, fields = transform_solve(
        "Y", lambda: eigs(op, 5, sigma=1.7, ncv=40, tol=1e-8,
                          inner_solver="bicgstab"), counts)
    check_transformed("solve Y", S, vals, V, refs["B"], scale)
    record("Y", hist, wall, fields)
    del V

    print("phase 28: solve Z, the same matrix, k=5, sigma=1.42 (interior, "
          "indefinite), ncv=40, gmres inner solves (restart 80)")
    (vals, V), hist, wall, fields = transform_solve(
        "Z", lambda: eigs(op, 5, sigma=1.42, ncv=40, tol=1e-8,
                          inner_solver="gmres"), counts)
    ten = reference(references, "Z")
    want = ten[np.argsort(np.abs(ten - 1.42), kind="stable")[:5]]
    check_transformed("solve Z", S, vals, V, want, scale)
    record("Z", hist, wall, fields)
    del V, op

    R = mats["reflect"]
    ref = refs["O_svds"]
    sigma = 1.1 * float(ref.max())
    print(f"phase 29: svds of the reflected scattered matrix, k=5, sigma=1.1 "
          f"s_max = {sigma:.6g}, ncv=40, gmres inner solves on the Gram")
    op = as_operator(R, dtype=torch.float64, device=device)
    companions = gram_companions(R, op)
    (U, s, Vh, hist), _, wall, fields = transform_solve(
        "svds_sigma", lambda: svds(op, 5, sigma=sigma, ncv=40, tol=1e-8,
                                   companions=companions, return_history=True),
        counts)
    Uh, Vt = host_array(U), host_array(Vh).T
    sv_err = float(np.abs(np.sort(s) - np.sort(ref)).max() / ref.max())
    r_av = float(np.linalg.norm(R @ Vt - Uh * s, axis=0).max() / ref.max())
    r_atu = float(np.linalg.norm(R.T @ Uh - Vt * s, axis=0).max() / ref.max())
    orth = max(np.abs(Uh.T @ Uh - np.eye(5)).max(), np.abs(Vt.T @ Vt - np.eye(5)).max())
    print(f"  singular values {s}; solve O's ARPACK {ref}")
    print(f"  relative error {sv_err:.3e} (limit 1e-9); |Av - su| / s_max "
          f"{r_av:.3e}, |A^T u - sv| / s_max {r_atu:.3e} (limits 1e-7); "
          f"orthonormality {orth:.3e} (limit 1e-10)")
    if not (sv_err <= 1e-9 and r_av <= 1e-7 and r_atu <= 1e-7 and orth <= 1e-10):
        fail("the sigma svds disagrees with ARPACK's svds or its triplets are off")
    record("svds_sigma", hist, wall, fields)
    del U, Vh, op, companions

    Mm = mats["mass"]
    m = Mm.diagonal()
    scale = float(np.abs(exact).max() / m.min())     # bounds the pencil's |lambda|
    print(f"phase 30: the pencil, eigsh(laplace_2d({side}), k=5, M=diag(m), m "
          "uniform on [0.5, 1.5] (seed 9), sigma=0.01, ncv=40, cg inner solves)")
    op = as_operator(A, dtype=torch.float64, device=device)
    (vals, X), hist, wall, fields = transform_solve(
        "pencil", lambda: eigsh(op, 5, M=Mm, sigma=0.01, ncv=40, tol=1e-8,
                                inner_solver="cg"), counts)
    ref = reference(references, "pencil")
    val_err = float(np.abs(np.sort(vals) - ref).max())
    print(f"  eigenvalues {np.sort(vals)}; ARPACK on M^-1/2 A M^-1/2 {ref}; "
          f"error {val_err:.3e} (limit 1e-9)")
    if not val_err <= 1e-9:
        fail("the pencil disagrees with ARPACK's values nearest sigma")
    res, norm_err, orth_err = vector_residual(A, vals, X, scale, B=Mm)
    # eigsh M-normalizes each vector, as the JAX package's does; it does not
    # M-orthogonalize them, and the pair split from laplace's double
    # eigenvalue by M lies 1.3e-7 apart: their M-inner product is
    # tol-accurate, held to the 1e-6 of the JAX package's own pencil test
    # (scripts/pencil_orthogonality.py reads both packages' on smaller
    # pencils).
    if not (res <= 1e-7 and norm_err <= 1e-10 and orth_err <= 1e-6
            and not X.is_complex()):
        fail("the pencil: residual or M-orthonormality out of bounds")
    record("pencil", hist, wall, fields)
    del X, op

    L = mats["laplace300"]
    side = round(L.shape[0] ** 0.5)
    exact = np.sort(matrices.laplace_2d_eigen(side))
    print(f"phase 31: splu, eigsh(laplace_2d({side}) as SciPy CSR, k=5, "
          f"sigma=0.01, ncv=40, inner_solver='splu', device={device!r}): the LU "
          "on the host")
    (vals, V), hist, wall, fields = transform_solve(
        "splu", lambda: eigsh(L, 5, sigma=0.01, ncv=40, tol=1e-8,
                              inner_solver="splu", device=device), counts)
    if V.device.type != torch.device(device).type:
        fail(f"splu returned its vectors on {V.device}")
    check_nearest("splu", vals, exact, 0.01, 5)
    res, norm_err, orth_err = vector_residual(L, vals, V, float(np.abs(exact).max()))
    if not (res <= 1e-7 and max(norm_err, orth_err) <= 1e-10):
        fail("splu: residual or orthonormality out of bounds")
    record("splu", hist, wall, fields)
    return rows, extra


def check_transformed(label, A, vals, V, want, scale):
    """An ``eigs`` shift-invert solve against ARPACK's values (Hungarian
    matching, 1e-9) and by its vectors' residual (1e-7 of ``scale``)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(vals[:, None] - want[None, :])
    ri, ci = linear_sum_assignment(cost)
    match_err = float(cost[ri, ci].max())
    print(f"  eigenvalues {np.sort_complex(vals)}; ARPACK {np.sort_complex(want)}; "
          f"matched error {match_err:.3e} (limit 1e-9)")
    res, _, _ = vector_residual(A, vals, V, scale, hermitian=False)
    if not (match_err <= 1e-9 and res <= 1e-7):
        fail(f"{label} disagrees with ARPACK or its residual is out of bounds")


# The filtered and explicit-restart path (phases 32-34).
FILTER_WINDOW_64 = (-11.93, -11.89)   # 60 values of laplace_3d_eigen(64)
FILTER_WINDOW_48 = (-11.80, -11.77)   # 36 values of laplace_3d_eigen(48)
FILTERED_KERNELS = {   # solve: {dtype: the kernels it must launch in it}
    "32": {"float64": ("spmv_dia_cols", "spmv_dia", "masked_project",
                       "project_update_norm")},
    "33": {"float32": ("spmv_ell_cols", "spmv_ell", "masked_project",
                       "project_update_norm"),
           "float64": ("spmv_ell_cols",)},
    "34": {"float64": ("spmv_ell_cols",),
           "complex128": ("masked_project", "project_update_norm")},
}
#: The JAX package's eigsh_window on the CPU, tol 1e-8, max |V_i^T V_j|
#: across slices (scripts/window_orthogonality.py): laplace(400) and
#: laplace_3d(16), 3 slices each.
JAX_ACROSS_SLICES = {"laplace(400)": 1.564e-13, "laplace_3d(16)": 8.543e-14}


def filtered_solve(label, run, dcounts):
    """Run one filtered or explicit-restart solve (``run()``), print its
    wall and peak memory, and fail unless it launched the kernels of
    ``FILTERED_KERNELS[label]`` in their dtypes.  Returns ``(out, wall)``."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    before = dcounts()
    sync()
    t0 = time.perf_counter()
    out = run()
    sync()
    wall = time.perf_counter() - t0
    after = dcounts()
    launched = {k: {t: n - before[k].get(t, 0) for t, n in v.items()
                    if n != before[k].get(t, 0)}
                for k, v in after.items() if v != before[k]}
    print(f"  solve {label}: wall {wall:.4f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; kernels "
          f"launched: {launched}")
    for tag, names in FILTERED_KERNELS[label].items():
        check_launched_dtype(f"solve {label}", before, after, names,
                             getattr(torch, tag))
    return out, wall


def print_filter_history(hist):
    """The geometry and phases of a filtered solve (``eigsh_window``'s
    slices or ``eigsh_filtered``'s one)."""
    slices = getattr(hist, "slices", None) or [hist.geometry]
    print(f"  matvecs {hist.total_matvecs}, sweeps {int(hist.restarts.max())}, "
          f"slices {len(slices)}")
    for g in slices:
        print(f"    slice [{g['interval'][0]:.6f}, {g['interval'][1]:.6f}]: s "
              f"{g['s']}, degree {g['degree']}, sweeps {g['sweeps']} (float64 "
              f"continuation {g['f64_sweeps']} sweeps, {g['f64_matvecs']} matvecs)")
    print("  phases: " + "; ".join(f"{k} {v['seconds']:.3f} s x{v['calls']}"
                                  for k, v in sorted(hist.phases.items())))


def check_filtered(label, A, vals, V, want, scale, slices):
    """Hold a filtered solve: every value within 1e-9 of ``want`` (the
    exact values it must find, ascending), ``||Av - lambda v|| / scale <=
    1e-7`` (``scale`` the enclosure's largest magnitude), the vectors
    within each slice orthonormal within 1e-10, and across slices
    ``|<v_i, v_j>| <= (||r_i|| + ||r_j||) / |lambda_i - lambda_j| + 1e-12``
    (exact for a symmetric A, ``r`` the residuals).  Returns the largest
    overlap across slices."""
    import numpy as np

    Vh = host_array(V)
    if len(vals) != len(want):
        fail(f"{label}: found {len(vals)} values, want {len(want)}")
    err = float(np.abs(np.sort(vals) - want).max())
    R = np.linalg.norm(A @ Vh - Vh * vals[None, :], axis=0)
    G = np.abs(Vh.T @ Vh)
    cuts = [g["interval"][0] for g in slices] + [slices[-1]["interval"][1]]
    owner = np.searchsorted(np.asarray(cuts)[1:-1], vals, side="right")
    within, across, excess = 0.0, 0.0, 0.0
    for i in np.unique(owner):
        mine = owner == i
        within = max(within, float(np.abs(G[np.ix_(mine, mine)]
                                          - np.eye(int(mine.sum()))).max()))
        other = ~mine
        if other.any():
            gap = np.abs(vals[mine][:, None] - vals[other][None, :])
            bound = (R[mine][:, None] + R[other][None, :]) / np.maximum(gap, 1e-300)
            over = G[np.ix_(mine, other)]
            across = max(across, float(over.max()))
            excess = max(excess, float((over - bound - 1e-12).max()))
    print(f"  eigenvalue error {err:.3e} (limit 1e-9); residual / {scale:.6g} "
          f"{R.max() / scale:.3e} (limit 1e-7); within a slice |V^T V - I| "
          f"{within:.3e} (limit 1e-10); across slices max |<v_i, v_j>| "
          f"{across:.3e} (bound (|r_i| + |r_j|) / gap + 1e-12, exceeded by "
          f"{max(excess, 0.0):.3e}; the JAX package's on the CPU tests: "
          f"{JAX_ACROSS_SLICES})")
    if not (err <= 1e-9 and R.max() / scale <= 1e-7 and within <= 1e-10
            and excess <= 0.0):
        fail(f"{label}: values, residual or orthogonality out of bounds")
    return across


def nearest(exact, window, k):
    """The k exact values inside ``window`` nearest its center (a tie in
    distance is either value)."""
    import numpy as np

    inside = exact[(exact >= window[0]) & (exact <= window[1])]
    c = 0.5 * (window[0] + window[1])
    return inside[np.argsort(np.abs(inside - c), kind="stable")[:k]]


def phase_filtered(mats, references, dcounts, refs, device="cuda"):
    """Phases 32-34: ``eigsh_window`` on laplace_3d(64) (DIA, float64),
    ``eigsh_filtered`` nev 10 on laplace_3d(48) as ELL in float32 with its
    float64 continuation, and both explicit-restart drivers on the
    scattered 2^20 matrix (ELL; complex128 work, the real kernel on two
    columns).  ``refs``: solve B's ARPACK values; ``references["Z"]``:
    ARPACK's ten largest-real values.  Returns ``([(label, history, wall),
    ...], {label: {summary field: value}}, {"dia": s of each phase-32
    slice, "ell": phase 33's s, "geometry": phase 32's first slice's,
    "geometry_33": phase 33's})``."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import (as_operator, eigsh_filtered, eigsh_window,
                                   explicit_restarts_with_deflation,
                                   naive_explicit_restarts, matrices)

    rows, extra = [], {}

    g = round(mats["laplace3d64"].shape[0] ** (1 / 3))
    print(f"phase 32: eigsh_window(laplace_3d({g}), {FILTER_WINDOW_64}, "
          f"tol=1e-8), float64, DIA")
    A = mats["laplace3d64"]
    op = as_operator(A, dtype=torch.float64, device=device)
    print(f"  operator {type(op).__name__} offsets {op.offsets}")
    exact = np.sort(matrices.laplace_3d_eigen(g))
    want = exact[(exact >= FILTER_WINDOW_64[0]) & (exact <= FILTER_WINDOW_64[1])]
    print(f"  {want.size} exact values inside the window")
    (vals, V, hist), wall = filtered_solve(
        "32", lambda: eigsh_window(op, FILTER_WINDOW_64, tol=1e-8,
                                   generator=torch.Generator().manual_seed(0)),
        dcounts)
    print_filter_history(hist)
    lmin, lmax = hist.slices[0]["bounds"]
    across = check_filtered("solve 32", A, vals, V, want,
                            max(abs(lmin), abs(lmax)), hist.slices)
    rows.append(("32", hist, wall))
    extra["32"] = {"slices": [{k: g_[k] for k in ("interval", "s", "degree", "sweeps")}
                              for g_ in hist.slices],
                   "across_slices": across, "phases": hist.phases}
    widths = {"dia": sorted({g_["s"] for g_ in hist.slices}),
              "geometry": hist.slices[0], "values_32": vals,
              "matvecs_32": hist.total_matvecs}
    del V

    g = round(mats["laplace3d48"].shape[0] ** (1 / 3))
    print(f"phase 33: eigsh_filtered(laplace_3d({g}) as ELL, nev=10, "
          f"{FILTER_WINDOW_48}, tol=1e-8), float32 with the float64 continuation")
    A = mats["laplace3d48"]
    op = as_operator(A, format="ell", device=device)     # float64 values
    exact = np.sort(matrices.laplace_3d_eigen(g))
    inside = exact[(exact >= FILTER_WINDOW_48[0]) & (exact <= FILTER_WINDOW_48[1])]
    print(f"  operator {type(op).__name__} L={op.data.shape[1]}; {inside.size} "
          "exact values inside the window")
    (vals, V, hist), wall = filtered_solve(
        "33", lambda: eigsh_filtered(op, 10, FILTER_WINDOW_48, tol=1e-8,
                                     dtype=torch.float32,
                                     generator=torch.Generator().manual_seed(1)),
        dcounts)
    print_filter_history(hist)
    geo = hist.geometry
    if V.dtype != torch.float64 or geo["f64_matvecs"] == 0:
        fail("solve 33 did not continue in float64")
    print(f"  matvecs: float32 phase {hist.total_matvecs - geo['f64_matvecs']}, "
          f"float64 continuation {geo['f64_matvecs']}")
    # the 10 nearest the center, by distance (a tie is either value)
    want = nearest(exact, FILTER_WINDOW_48, 10)
    c = 0.5 * sum(FILTER_WINDOW_48)
    dist_err = float(np.abs(np.sort(np.abs(vals - c))
                            - np.sort(np.abs(want - c))).max())
    print(f"  distances to the center against the 10 exact nearest: error "
          f"{dist_err:.3e} (limit 1e-9)")
    if not dist_err <= 1e-9:
        fail("solve 33 did not find the 10 values nearest the center")
    lmin, lmax = geo["bounds"]
    check_filtered("solve 33", A, vals, V,
                   np.sort(inside[np.abs(inside[:, None] - vals[None, :]).argmin(axis=0)]),
                   max(abs(lmin), abs(lmax)), [geo])
    rows.append(("33", hist, wall))
    extra["33"] = {"s": geo["s"], "degree": geo["degree"],
                   "float32_matvecs": hist.total_matvecs - geo["f64_matvecs"],
                   "float64_matvecs": geo["f64_matvecs"], "phases": hist.phases}
    widths["ell"], widths["geometry_33"] = [geo["s"]], geo
    del V

    print("phase 34: explicit_restarts_with_deflation(the scattered 2^20 matrix "
          "(ELL), nev=5, max_dim=40, LR, tol 1e-10) and naive_explicit_restarts "
          "(m=20), complex128 work")
    A = mats["scattered"]
    op = as_operator(A, dtype=torch.float64, device=device)
    (vals, V, hist), wall = filtered_solve(
        "34", lambda: explicit_restarts_with_deflation(
            op, 5, max_dim=40, stopping_criterion=1e-10, sort_function="LR",
            generator=torch.Generator().manual_seed(2)), dcounts)
    ref = np.sort_complex(refs["B"])
    err = float(np.max(np.abs(np.sort_complex(vals) - ref) / np.abs(ref)))
    Vh = host_array(V)
    res = float((np.linalg.norm(A @ Vh - Vh * vals[None, :], axis=0)
                 / np.abs(vals)).max())
    print(f"  deflation: matvecs {hist.total_matvecs} (a slot {hist.matvecs.tolist()}), "
          f"restarts {hist.restarts.tolist()}; eigenvalues {np.sort_complex(vals)}; "
          f"against solve B's ARPACK values: relative error {err:.3e} (limit "
          f"1e-9); residual / |lambda| {res:.3e} (limit 1e-7)")
    if not (err <= 1e-9 and res <= 1e-7):
        fail("solve 34 (deflation) disagrees with ARPACK")
    rows.append(("34", hist, wall))
    del V
    before = dcounts()
    sync()
    t0 = time.perf_counter()
    ritz, converged, n_restarts = naive_explicit_restarts(
        op, 20, stopping_criterion=1e-10, max_restarts=100,
        generator=torch.Generator().manual_seed(3))
    sync()
    wall_naive = time.perf_counter() - t0
    products = (dcounts()["spmv_ell_cols"].get("float64", 0)
                - before["spmv_ell_cols"].get("float64", 0))
    top = reference(references, "Z")
    lam = top[np.argmax(np.abs(top))]
    err = abs(ritz.values[0] - lam) / abs(lam)
    print(f"  naive: converged {converged} after {n_restarts} restarts, "
          f"{products} products (Arnoldi steps and the true-residual checks' "
          f"two columns a check), wall {wall_naive:.4f} s; value "
          f"{ritz.values[0]:.12f} against ARPACK's largest {lam:.12f}: "
          f"relative error {err:.3e} (limit 1e-9)")
    if not (converged and err <= 1e-9):
        fail("solve 34 (naive) disagrees with ARPACK")
    extra["34"] = {"naive_restarts": n_restarts, "naive_products": products,
                   "naive_wall_s": wall_naive}
    return rows, extra, widths


def ring_time(mesh):
    """``(seconds, exchanges)``: the host time the ring exchange has taken
    on ``mesh`` so far (its clock runs under ``ARNOLDI_PHASES``, which
    ``main`` sets) and the exchanges started."""
    rep = mesh.clock.report()
    return (sum(rep.get(k, {}).get("seconds", 0.0)
                for k in ("mesh.ring_start", "mesh.ring_wait")),
            rep.get("mesh.ring_start", {}).get("calls", 0))


def filter_sweep_split(op, geometry, mesh=None, warm=True):
    """One filtered sweep of ``op`` at ``geometry``'s s, degree and window,
    from a random orthonormal block, under the profiler (after a warm sweep
    when ``warm``): device time by kernel family (the DIA or ELL kernel,
    copies, torch's elementwise kernels, the gemms, the rest) and the busy
    share of the profiled wall; under a row ``mesh`` (``op`` this rank's sharded
    block) also the ring exchange's host time from the mesh's clock.  Rank
    0 prints."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arnoldi_tpu_torch.ops.ortho import block_cgs2
    from arnoldi_tpu_torch.solvers import filtered

    (a, b), (lmin, lmax) = geometry["interval"], geometry["bounds"]
    s, degree = geometry["s"], geometry["degree"]
    sin_eff = filtered._edge_sine(a, b, lmin, lmax)
    delta = 2.5 * (lmax - lmin) * sin_eff / degree
    coeffs = filtered.jackson_cheby_coeffs(max(a - delta, lmin), min(b + delta, lmax),
                                           lmin, lmax, degree)
    rank = 0 if mesh is None else mesh.rank
    gen = torch.Generator(device=op.device).manual_seed(5 + rank)
    X = torch.randn(s, op.shape[0], generator=gen, device=op.device, dtype=op.dtype)
    X = block_cgs2(X, X, 0, mesh=mesh)[1]

    def sweep():
        return filtered._filter_rr_step(op, X, coeffs, lmin, lmax, mesh=mesh)

    if warm:
        sweep()
    sync()
    if mesh is not None:
        mesh.barrier()
        ring0 = ring_time(mesh)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sweep()
        sync()
    wall = time.perf_counter() - t0
    dia = "spmv_dia_cols" if mesh is None else "spmv_dia_ext_cols"
    family = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name().lower()
        key = (dia if "spmv_dia" in name else
               "spmv_ell_cols" if "spmv_ell" in name else
               "memcpy" if "memcpy" in name else
               "elementwise" if "elementwise" in name or "vectorized" in name else
               "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass", "sm90")) else
               "other")
        family[key] = family.get(key, 0.0) + ev.duration_ns() / 1e6
    total = sum(family.values())
    out = {"s": s, "degree": degree, "profiled_wall_s": wall,
           "device_ms": total, "busy": total / 1e3 / wall, "by_family_ms": family}
    where = f"n={op.shape[0]}"
    if mesh is not None:
        ring1 = ring_time(mesh)
        out.update(exchange_host_s=ring1[0] - ring0[0],
                   exchanges=ring1[1] - ring0[1])
        where = (f"rank 0 of {mesh.size}, {op.shape[0]} rows; the ring exchange "
                 f"{out['exchange_host_s']:.4f} s of host time over "
                 f"{out['exchanges']} exchanges")
    if rank == 0:
        print(f"  one sweep at s={s}, degree={degree} ({where}) under the "
              f"profiler: wall {wall:.4f} s, device {total:.3f} ms (busy "
              f"{100 * total / 1e3 / wall:.1f} %); by family (ms): "
              + "; ".join(f"{k} {v:.3f} ({100 * v / total:.1f} %)"
                          for k, v in sorted(family.items(), key=lambda kv: -kv[1])))
    return out


FILTER_TAIL = 8 * 37 + 3     # an odd tail: 37 passes of 8 columns and one of 3


def phase_filter_kernels(mats, widths, gen, device="cuda"):
    """Phase 1 at the filter's widths (run after phase 34, at the widths
    phases 32 and 33 took; the launches here are outside every counted
    window): ``spmv_dia_cols`` on laplace_3d(64) and ``spmv_ell_cols`` on
    laplace_3d(48) as ELL against their plain versions at b = 32, 64, each
    slice's s and 8k + 3, in float64 and float32, every column of either
    b-column kernel at every width bit for bit against its single-column
    kernel; timed (events and profiler device time), bound (bands or
    nonzeros read once, X read and Y written once) and cuSPARSE's SpMM at b
    = the g = 64 slice's s in float64 (DIA, with the host enqueue time of
    both) and at b = phase 33's s in float32 and float64 (ELL); ten
    profiled ELL calls at that s must show one kernel a call.  Returns
    ``{record name: KernelRecord}``."""
    import torch

    from arnoldi_tpu_torch.linop import BandedOperator, EllOperator, cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_banded, spmv_ell

    dev = torch.device(device)
    cases = (   # matrix, format, {timed dtype: record}, widths, label
        ("laplace3d64", BandedOperator, {torch.float64: "spmv_dia_cols:filter"},
         widths["dia"], "DIA laplace_3d(64)"),
        ("laplace3d48", EllOperator, {torch.float32: "spmv_ell_cols:filter",
                                      torch.float64: "spmv_ell_cols:filter_f64"},
         widths["ell"], "ELL laplace_3d(48)"))
    recs = {}
    for key, fmt, timed, slice_widths, label in cases:
        op64 = fmt.from_scipy(mats[key], device=dev)
        for dtype in (torch.float64, torch.float32):
            op = cast_operator(op64, dtype)
            if fmt is BandedOperator:
                def plain(X):
                    return spmv_banded.banded_matvec_plain(op.bands, X, op.offsets)

                def nbytes(b):
                    return (op.bands.numel() + 2 * b * op.shape[0]) * item
            else:
                def plain(X):
                    return ell_plain(op.data, op.cols, X)

                def nbytes(b):
                    return ell_bytes(op, b)
            item = torch.empty((), dtype=dtype).element_size()
            if dtype in timed:
                r = recs[timed[dtype]] = KernelRecord(dtype)
            for b in sorted({32, 64, FILTER_TAIL, *slice_widths}):
                X = torch.randn(b, op.shape[1], generator=gen, device=dev, dtype=dtype)
                Y = op.matmat_rows(X)
                r.check(f"{label} {tuple(op.shape)} b={b}", dtype, Y, plain(X))
                # every column, bit for bit, is the single-column kernel's
                single = torch.stack([op.matvec(X[j]) for j in range(b)])
                if not torch.equal(Y, single):
                    fail(f"{label} b={b} {dtype}: a column differs from the "
                         "single-column kernel")
                del Y, single
                if b == max(slice_widths) and dtype in timed:
                    if fmt is EllOperator:
                        n = kernels_in_calls(lambda: op.matmat_rows(X), "spmv_ell")
                        print(f"  ell_matmat at b={b} {dtype} under the profiler: "
                              f"{n} kernel launches in 10 calls")
                        if not 1 <= n <= 10:
                            fail(f"ell_matmat at b={b}: {n} kernels in 10 calls, "
                                 "not one a call")
                    r.time(lambda: op.matmat_rows(X), lambda: plain(X),
                           library_enqueue=fmt is BandedOperator)
                    r.set_bound(nbytes(b), 2 * op.nnz * b)
                    A_csr, Xt = csr_tensor(mats[key], dtype, dev), X.T.contiguous()
                    r.time_library(f"A_csr @ Xt (cuSPARSE SpMM, b={b})",
                                   lambda: A_csr @ Xt, plain(X).T)
                    del A_csr, Xt
                del X
        del op64, op
    sync()
    for name, r in recs.items():
        print_time(name, r)
    return recs


COMPLEX_BSR_KERNELS = ("spmv_bsr", "spmv_bsr_cols", "spmv_bsr_window",
                       "spmv_bsr_window_cols")
#: The complex BSR forms each complex dtype's solves must launch (phases 35-39).
COMPLEX_BSR_PATH = {"complex128": COMPLEX_BSR_KERNELS,
                    "complex64": ("spmv_bsr", "spmv_bsr_cols")}
COMPLEX_WINDOW_EDGE_NB = (1, 3, 4, 5, 8, 11)   # 8, 11: passes of 4 in complex128
CHECKPOINT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke")


def window_matrix(n):
    """"banded-1024" (solves D, H; phased, DB and the BSR ``svds``)."""
    from arnoldi_tpu_torch import matrices

    return matrices.random_scattered(n, 24, seed=2, bandwidth=1024, block=8)


def phase_complex_bsr_kernels(mats, gen, device="cuda"):
    """Phase 1, complex BSR: the gather kernel (``spmv_bsr``, and the staged
    8 x 8 ``spmv_bsr_cols``) on the phased scattered matrix (solves RB, VB)
    and the window kernel (``spmv_bsr_window``, ``spmv_bsr_window_cols``)
    on the phased banded-1024 matrix (solve DB), as BSR-8 in complex128 and
    complex64, b = 1 and 8, each against its plain version (1e-12 and
    1e-5), every column of a b-column form bit for bit against the
    single-column kernel and the window kernel against the gather kernel;
    each timed beside its bound (the nonzeros, their blocks' ids, x and y
    at 3.35 TB/s; 8 flops a complex multiply-add) and its library call;
    the complex128 window kernel at b = 8 also with 2 columns a pass in two
    stages, against the plan's 4 in one; then the complex128 edge shapes
    (``phase_complex_bsr_edges``).  Returns ``({(kernel, dtype name):
    KernelRecord}, {plan: ms})``.  ``device="cpu"`` rehearses it with the
    plain versions (stub the timers)."""
    import torch

    from arnoldi_tpu_torch import as_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    dev = torch.device(device)
    brec, plans = {}, {}
    for dtype in (torch.complex128, torch.complex64):
        tag = str(dtype).removeprefix("torch.")
        rec = {name: KernelRecord(dtype) for name in COMPLEX_BSR_KERNELS}
        brec.update({(name, tag): r for name, r in rec.items()})
        item = torch.empty((), dtype=dtype).element_size()
        for kind, key in (("gather", "phased"), ("window", "phased_window")):
            A = mats[key]
            op = as_operator(A, dtype=dtype, format=("bsr", (8, 8)), device=dev)
            if op.uses_window != (kind == "window"):
                fail(f"complex BSR {key}: expected the {kind} kernel")
            blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
            x = torch.randn(op.n_cols, generator=gen, device=dev, dtype=dtype)
            X = torch.randn(B_COLS, op.n_cols, generator=gen, device=dev, dtype=dtype)
            forms = {
                "spmv_bsr": (lambda: spmv_bsr.bsr_matvec(blk, ids, x, nr),
                             lambda: spmv_bsr.bsr_matvec_plain(blk, ids, x, nr)),
                "spmv_bsr_cols": (lambda: spmv_bsr.bsr_matmat(blk, ids, X, nr),
                                  lambda: spmv_bsr.bsr_matvec_plain(blk, ids, X, nr)),
                "spmv_bsr_window": (
                    lambda: spmv_bsr.bsr_window_matvec(blk, win, x, nr),
                    lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, x, nr)),
                "spmv_bsr_window_cols": (
                    lambda: spmv_bsr.bsr_window_matmat(blk, win, X, nr),
                    lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr))}
            names = COMPLEX_BSR_KERNELS[:2] if kind == "gather" else COMPLEX_BSR_KERNELS[2:]
            nnzb = int((blk != 0).any(-1).any(-1).sum())
            io = (op.n_rows + op.n_cols) * item
            A_lib = bsr_tensor(A, dtype, dev)
            Xt = X.T.contiguous()
            for name in names:
                kernel, plain = forms[name]
                nb = B_COLS if name.endswith("_cols") else 1
                r = rec[name]
                r.check(f"BSR-8 {key} ({kind}) b={nb}", dtype, kernel(), plain())
                r.time(kernel, plain)
                r.set_bound(A.nnz * item + nnzb * 4 + nb * io, 8 * A.nnz * nb)
                rhs = x if nb == 1 else Xt
                r.time_library(f"A_bsr @ {'x' if nb == 1 else 'Xt'} (cuSPARSE BSR "
                               f"{'SpMV' if nb == 1 else 'SpMM'}, blocks (8, 8), {tag})",
                               lambda rhs=rhs: A_lib @ rhs,
                               plain() if nb == 1 else plain().T)
            if dev.type == "cuda":
                Y = forms[names[1]][0]()
                single = (spmv_bsr.bsr_matvec if kind == "gather"
                          else lambda b, i, v, n: spmv_bsr.bsr_window_matvec(b, win, v, n))
                for j in range(B_COLS):
                    if not torch.equal(Y[j], single(blk, ids, X[j].contiguous(), nr)):
                        fail(f"{names[1]} {tag}: column {j} differs from the "
                             "single-column kernel")
                if kind == "window" and not (
                        torch.equal(Y, spmv_bsr.bsr_matmat(blk, ids, X, nr)) and torch.equal(
                            forms["spmv_bsr_window"][0](), forms["spmv_bsr"][0]())):
                    fail(f"complex BSR window {tag}: window and gather kernels differ")
            if kind == "window" and dtype == torch.complex128:
                # The plan's 4 columns a pass in one stage, against 2 a
                # pass in two stages (the blocks read 4 times).
                col_bytes = (win.width + 1) * 8 * item
                for per_pass in (4, 2):
                    def call(per_pass=per_pass):
                        return spmv_bsr.bsr_window_matmat(blk, win, X, nr,
                                                          per_pass=per_pass)
                    if dev.type == "cuda" and not torch.equal(call(), forms[names[1]][0]()):
                        fail(f"complex128 window plan {per_pass}: other bits")
                    ms, dev_ms = cuda_ms(call), device_ms(call)
                    stages = spmv_bsr.window_stages(per_pass, col_bytes)
                    plans[f"{per_pass}_per_pass_{stages}_stage"] = {"ms": ms, "dev_ms": dev_ms}
                    print(f"  complex128 window b={B_COLS}, {per_pass} columns a pass, "
                          f"{stages} stage(s): {ms:.4f} ms (device {dev_ms})")
            del op, blk, ids, win, x, X, Xt, A_lib
        sync()
        for name, r in rec.items():
            print_time(f"{name}:{tag}", r)
    phase_complex_bsr_edges({name: brec[(name, "complex128")] for name in
                             COMPLEX_BSR_KERNELS}, gen, device)
    return brec, plans


def phase_complex_bsr_edges(rec, gen, device="cuda"):
    """Phase 1, complex128 BSR edge shapes: the phased banded matrix of
    2^17 - 5 rows as BSR (8, 8) and (4, 4) (window kernels) at b in
    COMPLEX_WINDOW_EDGE_NB, and the phased scattered one of 2^17 - 5 rows
    (gather kernels; the staged 8 x 8 one at b in GATHER_EDGE_NB), x / X
    aligned and as views one element in, each against its plain version,
    every column bit for bit against the single-column kernel (and the 8 x
    8 window kernel against the gather kernel)."""
    import torch

    from arnoldi_tpu_torch import as_operator, matrices
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    dev = torch.device(device)
    c128 = torch.complex128
    n = 2**17 - 5
    cuda = dev.type == "cuda"

    def views(nb, nc):
        for view in (False, True):
            buf = torch.randn(nb * nc + view, generator=gen, device=dev, dtype=c128)
            yield view, buf[int(view):].view(nb, nc)

    A = phased(matrices.random_scattered(2**17, 24, seed=3, bandwidth=1024,
                                         block=8)[:n, :n])
    for shape in ((8, 8), (4, 4)):
        op = as_operator(A, format=("bsr", shape), device=dev)
        if not op.uses_window or op.dtype != c128:
            fail(f"complex window edges: the BSR {shape} operator should take the "
                 "complex128 window kernel")
        blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
        label = f"complex BSR window edge {shape} ({n} rows, Wt={win.width})"
        for nb in COMPLEX_WINDOW_EDGE_NB:
            for view, X in views(nb, n):
                tag = f"{label} b={nb}{', view one in' if view else ''}"
                if nb == 1:
                    rec["spmv_bsr_window"].check(
                        tag, c128, spmv_bsr.bsr_window_matvec(blk, win, X[0], nr),
                        spmv_bsr.bsr_window_matvec_plain(blk, win, X[0], nr))
                    continue
                Y = spmv_bsr.bsr_window_matmat(blk, win, X, nr)
                rec["spmv_bsr_window_cols"].check(
                    tag, c128, Y, spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr))
                for j in range(nb if cuda else 0):
                    if not torch.equal(Y[j], spmv_bsr.bsr_window_matvec(
                            blk, win, X[j].contiguous(), nr)):
                        fail(f"{tag}: column {j} differs from the single-column kernel")
                if cuda and shape == (8, 8) and not torch.equal(
                        Y, spmv_bsr.bsr_matmat(blk, ids, X, nr)):
                    fail(f"{tag}: window and gather kernels differ")
        del op, blk, ids, win
    A = phased(matrices.random_scattered(2**17, 24, seed=3, bandwidth=2**14,
                                         block=8)[:n, :n])
    op = as_operator(A, format=("bsr", (8, 8)), device=dev)
    if op.uses_window:
        fail("complex gather edges: the operator should take the gather kernel")
    blk, ids, nr = op.blocks, op.block_cols, op.n_rows
    label = f"complex BSR gather edge {tuple(blk.shape)}"
    for view, X in views(1, n):
        rec["spmv_bsr"].check(f"{label} b=1{', view one in' if view else ''}", c128,
                              spmv_bsr.bsr_matvec(blk, ids, X[0], nr),
                              spmv_bsr.bsr_matvec_plain(blk, ids, X[0], nr))
    for nb in GATHER_EDGE_NB:
        for view, X in views(nb, n):
            tag = f"{label} b={nb}{', view one in' if view else ''}"
            before = spmv_bsr.bsr_matmat.gather8_launches
            Y = spmv_bsr.bsr_matmat(blk, ids, X, nr)
            if cuda and spmv_bsr.bsr_matmat.gather8_launches != before + 1:
                fail(f"{tag}: the staged gather kernel did not launch")
            rec["spmv_bsr_cols"].check(tag, c128, Y,
                                       spmv_bsr.bsr_matvec_plain(blk, ids, X, nr))
            for j in range(nb if cuda else 0):
                if not torch.equal(Y[j], spmv_bsr.bsr_matvec(blk, ids,
                                                             X[j].contiguous(), nr)):
                    fail(f"{tag}: column {j} differs from the single-column kernel")
    del op, blk, ids


def phase_complex_bsr(mats, references, counts, dcounts, refs, device="cuda"):
    """Phases 35-39: complex BSR solves and checkpoint/resume.  RB (the
    phased scattered matrix as complex128 BSR-8: gather kernels, scalar and
    b = 8), DB (the phased banded-1024 matrix: window kernels, scalar and
    b = 8), VB (RB's operator in complex64), ``svds`` of the reflected form
    of DB's matrix (its adjoint leg the materialized conjugate transpose,
    BSR too: DB's own has no padded layout), and solve A cut at 50 restarts
    into a snapshot and resumed.  ``references``: the
    ARPACK references (``start_references``); ``refs``: solve A's matvecs,
    restarts and T.  Returns ``([(label, history, wall), ...], {label:
    {summary field: value}})``."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator, partial_schur, svds
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr
    from arnoldi_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    c128, c64 = torch.complex128, torch.complex64
    rows, extra = [], {}

    def bsr(A, label):
        t0 = time.perf_counter()
        op = as_operator(A, format=("bsr", (8, 8)), device=device)
        sync()
        print(f"  {label}: {op.dtype} BsrOperator blocks {tuple(op.blocks.shape)}, "
              f"window {op.window.width} block-columns -> "
              f"{'window' if op.uses_window else 'gather'} kernel, built in "
              f"{time.perf_counter() - t0:.3f} s")
        if op.dtype != c128:
            fail(f"{label}: a {op.dtype} operator, not complex128")
        return op

    A = mats["phased"]
    print("phase 35: solve RB, the phased scattered matrix as complex128 BSR-8, LR, "
          f"k=5, m=40, scalar and block_size={B_COLS}")
    op_rb = bsr(A, "solve RB")
    if op_rb.uses_window:
        fail("solve RB: the phased scattered matrix should take the gather kernel")
    ref_r = reference(references, "R")
    before = dcounts()
    Q, T, hist, wall = solve("solve RB", op_rb, 5, "LR", 40, counts, dtype=c128)
    check_launched_dtype("solve RB", before, dcounts(),
                         ("spmv_bsr", "masked_project", "project_update_norm"), c128)
    check_triangular("solve RB", T)
    check_arpack("solve RB", A, Q, T, ref_r)
    lam_rb = np.diag(host_array(T))
    rows.append(("RB", hist, wall))
    del Q
    before, staged = dcounts(), spmv_bsr.bsr_matmat.gather8_launches
    Q, T, hist, wall = solve(f"solve RB, block_size={B_COLS}", op_rb, 5, "LR", 40,
                             counts, dtype=c128, block_size=B_COLS)
    after = dcounts()
    check_launched_dtype("solve RB (block)", before, after, ("spmv_bsr_cols",), c128)
    staged = spmv_bsr.bsr_matmat.gather8_launches - staged
    calls = (after["spmv_bsr_cols"].get("complex128", 0)
             - before["spmv_bsr_cols"].get("complex128", 0))
    print(f"  spmv_bsr_cols launches of the staged 8 x 8 gather kernel: {staged} of {calls}")
    if torch.device(device).type == "cuda" and staged != calls:
        fail("solve RB (block) did not launch spmv_bsr_gather8_kernel on every call")
    check_triangular("solve RB (block)", T)
    check_arpack("solve RB (block)", A, Q, T, ref_r)
    rows.append(("RB8", hist, wall))
    del Q

    A_db = mats["phased_window"]
    print("phase 36: solve DB, the phased banded-1024 matrix as complex128 BSR-8, "
          f"LR, k=5, m=40, scalar and block_size={B_COLS}")
    op_db = bsr(A_db, "solve DB")
    if not op_db.uses_window:
        fail("solve DB: the phased banded-1024 matrix's window should fit")
    ref_db = reference(references, "DB")
    for label, b, names in (("DB", 1, ("spmv_bsr_window",)),
                            ("DB8", B_COLS, ("spmv_bsr_window_cols",))):
        before = dcounts()
        Q, T, hist, wall = solve(f"solve {label}", op_db, 5, "LR", 40, counts,
                                 dtype=c128, block_size=b)
        check_launched_dtype(f"solve {label}", before, dcounts(), names, c128)
        check_triangular(f"solve {label}", T)
        check_arpack(f"solve {label}", A_db, Q, T, ref_db)
        rows.append((label, hist, wall))
        del Q

    print("phase 37: solve VB, RB's operator in complex64, tol 1e-5, LR, k=5, m=40, "
          f"scalar and block_size={B_COLS}")
    for label, b, names in (("VB", 1, ("spmv_bsr", "masked_project",
                                       "project_update_norm")),
                            ("VB8", B_COLS, ("spmv_bsr_cols",))):
        before = dcounts()
        Q, T, hist, wall = solve(f"solve {label}", op_rb, 5, "LR", 40, counts,
                                 dtype=c64, tol=1e-5, block_size=b)
        check_launched_dtype(f"solve {label}", before, dcounts(), names, c64)
        if Q.dtype != c64 or "refine.continue" in hist.phases:
            fail(f"solve {label}: a {Q.dtype} result, or a refined one")
        check_triangular(f"solve {label}", T)
        err = matched_error(np.diag(host_array(T)), lam_rb)
        print(f"  eigenvalues {np.sort_complex(np.diag(host_array(T)))}; matched "
              f"error against solve RB {err:.3e} (limit 1e-4)")
        if not err <= 1e-4:
            fail(f"solve {label} disagrees with solve RB")
        rows.append((label, hist, wall))
        del Q
    del op_rb

    print("phase 38: svds of DB's phased banded-1024 matrix and of its reflected "
          "form as complex128 BSR-8, k=5, LM, tol 1e-8, m=40: Lanczos on A^H A, "
          "A^H the conjugate-transposed BSR")
    from arnoldi_tpu_torch.linop import SplitRowsOperator, adjoint_operator

    # DB's matrix clips its rows at the edges, so its first and last
    # block-columns hold ~64 blocks: its transpose splits those rows into
    # virtual rows and folds them back (SplitRowsOperator); the reflected
    # form's transpose keeps the plain layout.
    for label, A_sv, op_sv, key in (
            ("svds_db", A_db, op_db, "svds_db"),
            ("svds_bsr", mats["phased_window_reflect"], None, "svds_bsr")):
        if op_sv is None:
            op_sv = bsr(A_sv, "svds")
        before = dcounts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        U, s, Vh, hist = svds(op_sv, 5, which="LM", tol=1e-8, ncv=40, dtype=c128,
                              return_history=True)
        sync()
        wall = time.perf_counter() - t0
        report_solve(f"BSR svds ({label})", hist, wall, counts)
        adj = adjoint_operator(op_sv)
        inner = adj.inner if isinstance(adj, SplitRowsOperator) else adj
        if isinstance(adj, SplitRowsOperator):
            print(f"  A^H split: {adj.hub.numel()} hub block-rows into "
                  f"{inner.blocks.shape[0] - adj.n_keys} extra block-rows of "
                  f"{inner.blocks.shape[1]} slots, folded back")
        print(f"  A^H: BsrOperator blocks {tuple(inner.blocks.shape)}, window "
              f"{inner.window.width} -> "
              f"{'window' if inner.uses_window else 'gather'} kernel")
        check_launched_dtype(f"BSR svds ({label})", before, dcounts(),
                             ("spmv_bsr_window" if inner.uses_window
                              else "spmv_bsr",), c128)
        ref = reference(references, key)
        Uh, Vn = host_array(U), host_array(Vh).conj().T
        sv_err = float(np.abs(s - ref).max() / ref.max())
        r_av = float(np.linalg.norm(A_sv @ Vn - Uh * s, axis=0).max() / s.max())
        r_ahu = float(np.linalg.norm(A_sv.conj().T @ Uh - Vn * s, axis=0).max()
                      / s.max())
        orth = max(np.abs(Uh.conj().T @ Uh - np.eye(5)).max(),
                   np.abs(Vn.conj().T @ Vn - np.eye(5)).max())
        print(f"  singular values {s}; ARPACK {ref}")
        print(f"  relative error {sv_err:.3e} (limit 1e-9); |Av - su| / s_max "
              f"{r_av:.3e}, |A^H u - sv| / s_max {r_ahu:.3e} (limits 1e-7); "
              f"orthonormality {orth:.3e} (limit 1e-10)")
        if not (U.dtype == c128 and sv_err <= 1e-9 and r_av <= 1e-7
                and r_ahu <= 1e-7 and orth <= 1e-10):
            fail(f"BSR svds ({label}) disagrees with ARPACK's svds or its "
                 "triplets are off")
        rows.append((label, hist, wall))
        extra[label] = {"sv_err": sv_err, "r_av": r_av, "r_ahu": r_ahu}
        del U, Vh, op_sv, adj, inner
    del op_db

    A = mats["laplace"]
    print("phase 39: checkpoint: solve A cut at max_restarts=50 with a snapshot "
          "every 25 restarts, then resumed")
    op = as_operator(A, dtype=torch.float64, device=device)
    os.makedirs(CHECKPOINT_DIR, exist_ok=True)
    path = os.path.join(CHECKPOINT_DIR, "solve_a.npz")
    if os.path.exists(path):
        os.remove(path)
    args = dict(max_dim=80, stopping_criterion=1e-8, sort_function="LM",
                dtype=torch.float64, ortho="cgs2", checkpoint_path=path,
                checkpoint_every=25)
    t0 = time.perf_counter()
    try:
        partial_schur(op, 5, max_restarts=50, **args)
    except ValueError as e:
        if "Has not converged" not in str(e):
            raise
        print(f"  cut run raised ValueError ({e}) after "
              f"{time.perf_counter() - t0:.3f} s")
    else:
        fail("solve A at max_restarts=50 should not have converged")
    ck = load_checkpoint(path)
    size = os.path.getsize(path)
    print(f"  snapshot: restart {ck.restart}, pa {ck.pa}, V {ck.V.shape} {ck.V.dtype}, "
          f"{size} bytes, total_matvecs {ck.total_matvecs}")
    if ck.restart != 50:
        fail(f"checkpoint: the snapshot is of restart {ck.restart}, not 50")
    t0 = time.perf_counter()
    save_checkpoint(path + ".copy.npz", ck)
    rewrite = time.perf_counter() - t0
    os.remove(path + ".copy.npz")
    print(f"  writing it again from host memory (.npz, atomic rename): {rewrite:.4f} s")
    t0 = time.perf_counter()
    Q, T, hist = partial_schur(op, 5, max_restarts=1000, resume=True, **args)
    sync()
    wall = time.perf_counter() - t0
    report_solve("solve A resumed", hist, wall, counts)
    write = hist.phases.get("checkpoint", {})
    print(f"  snapshot writes in the resumed run: {write}")
    restarts = len(hist.residual_trace)
    diff = float(np.abs(host_array(T) - refs["A_T"]).max())
    print(f"  resumed: matvecs {hist.total_matvecs}, restarts {restarts}; solve A: "
          f"{refs['A_matvecs']}, {refs['A_restarts']}; max |T - T_A| {diff:.3e} "
          f"(limit 1e-12; bit-equal: {diff == 0.0})")
    if not (hist.total_matvecs == refs["A_matvecs"] and restarts == refs["A_restarts"]
            and diff <= 1e-12):
        fail("the resumed solve A differs from solve A")
    check_laplace("solve A resumed", A, Q, T, round(A.shape[0] ** 0.5))
    rows.append(("A_resumed", hist, wall))
    extra["A_resumed"] = {"snapshot_bytes": size, "snapshot_write": write,
                          "snapshot_rewrite_s": rewrite, "max_abs_dT": diff}
    os.remove(path)
    del Q, op
    return rows, extra


# The sharded path (phases 40-44): the port's parallel/ package over a
# row mesh of torch.distributed ranks on the one card.

#: The kernels the sharded path (phases 41-44) must launch (in every rank
#: of it, summed); the BSR halo runs whichever BSR kernel its shards take.
PARALLEL_KERNELS = ("spmv_dia_ext", "spmv_dia_ext_cols", "spmv_ell",
                    "masked_project", "project_update_norm")
MESH_RANKS = 2              # phases 42-44: ranks sharing the card over gloo
PARALLEL_TIMEOUT_S = 600


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def separated_banded(n, seed=3):
    """A symmetric 9-band matrix with five well-separated largest
    eigenvalues: the symmetric part of ``random_scattered(n, 24, seed=3,
    bandwidth=4)`` (DIA: 9 diagonals).  Phase 42's block solve over the DIA
    halo (``spmv_dia_ext_cols``) converges on it in a few restarts."""
    from arnoldi_tpu_torch import matrices

    R = matrices.random_scattered(n, 24, seed=seed, bandwidth=4)
    return ((R + R.T) / 2).tocsr()


def shard_window_csr(A, row0, row1, halo):
    """Rows [row0, row1) of ``A`` over the window columns [row0 - halo,
    row1 + halo) (the ring-halo shard's ``x``), as SciPy CSR."""
    import scipy.sparse as sp

    B = sp.coo_matrix(A.tocsr()[row0:row1])
    return sp.csr_matrix((B.data, (B.row, B.col - row0 + halo)),
                         shape=(row1 - row0, row1 - row0 + 2 * halo))


def random_banded(offsets, n, gen, device):
    """A float64 :class:`BandedOperator` of ``n`` rows with random bands at
    ``offsets``, zero where ``i + offset`` leaves the matrix (the DIA
    layout's convention)."""
    import torch

    from arnoldi_tpu_torch.linop import BandedOperator

    bands = torch.randn(len(offsets), n, generator=gen, device=device,
                        dtype=torch.float64)
    i = torch.arange(n, device=device)
    for d, off in enumerate(offsets):
        bands[d][(i + off < 0) | (i + off >= n)] = 0.0
    return BandedOperator(bands, tuple(offsets), int((bands != 0).sum()))


def phase_shard_kernels(mats, rec, gen, device="cuda"):
    """Phase 40: ``spmv_dia_ext`` and ``spmv_dia_ext_cols`` against their
    plain versions at the shapes the 2-rank DIA shards of phases 42-44 give
    them, on both ranks, b = 1 and 8: the whole block against the halo
    window, its first and last h rows alone (the rows the overlapped pass
    recomputes) and the block against the whole vector (the all-gather).
    Shards of laplace_2d(724) (5 bands, 262,088 rows, h = 724: solves A, I
    and phase 44) in float64 and complex128, each timed beside its bound
    and cuSPARSE's CSR product of the shard's window (the complex128
    records returned, ``{name: KernelRecord}``); and of solve
    E9's 9-band 2^20-row layout (random bands at offsets -4..4, 524,288
    rows, h = 4), float64.  Then the rectangular ELL and BSR-8 shards of
    the scattered matrix (halo 2^14 rows, 2^11 block rows) against theirs.
    Not counted."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator
    from arnoldi_tpu_torch.linop import BandedOperator, cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_banded, spmv_bsr, spmv_ell
    from arnoldi_tpu_torch.parallel import Mesh, halo_matvec_closure

    dev = torch.device(device)
    A = mats["laplace"]
    dia = BandedOperator.from_scipy(A, device=dev)
    cases = [("laplace_2d(724)", dia, dtype) for dtype in (torch.float64,
                                                           torch.complex128)]
    cases.append(("E9 layout", random_banded(range(-4, 5), 2**20, gen, dev),
                  torch.float64))
    forms = ((1, "spmv_dia_ext", spmv_banded.banded_matvec_ext),
             (8, "spmv_dia_ext_cols", spmv_banded.banded_matmat_ext))
    crec = {name: KernelRecord(torch.complex128) for _, name, _ in forms}
    for matrix, square, dtype in cases:
        op = cast_operator(square, dtype)
        n = op.shape[0]
        for rank in range(MESH_RANKS):
            local = halo_matvec_closure(op, Mesh(None, rank, MESH_RANKS, dev)).local
            h, n_local = local.x_base, local.bands.shape[1]
            row0 = rank * n_local
            for nb, name, wrap in forms:
                shape = (n_local + 2 * h,) if nb == 1 else (nb, n_local + 2 * h)
                x = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                x_all = torch.randn(shape[:-1] + (n,), generator=gen, device=dev,
                                    dtype=dtype)
                for label, xx, base, r0, rows in (
                        ("halo window", x, h, 0, None),
                        (f"first {h} rows", x, h, 0, h),
                        (f"last {h} rows", x, h, n_local - h, h),
                        ("all-gather", x_all, row0, 0, None)):
                    kw = dict(x_base=base, row0=r0, rows=rows)
                    rec[name].check(
                        f"{name} {matrix} rank {rank} {label} b={nb}", dtype,
                        wrap(local.bands, xx, local.offsets, **kw),
                        spmv_banded.banded_matvec_ext_plain(
                            local.bands, xx, local.offsets, **kw))
                if matrix == "laplace_2d(724)" and rank == 1:
                    time_shard_form(rec[name] if dtype == torch.float64
                                    else crec[name], wrap, local, x, nb,
                                    shard_window_csr(A, row0, row0 + n_local, h),
                                    dev)
        del op, local, x, x_all
    del dia, cases

    A = mats["scattered"]
    for fmt, label in (("ell", "ELL"), (("bsr", (8, 8)), "BSR-8")):
        op = as_operator(A, format=fmt, dtype=torch.float64, device=dev)
        for rank in range(MESH_RANKS):
            halo = halo_matvec_closure(op, Mesh(None, rank, MESH_RANKS, dev))
            local = halo.local
            width = local.shape[1]
            for nb in (1, 8):
                x = torch.randn((width,) if nb == 1 else (nb, width), generator=gen,
                                device=dev, dtype=torch.float64)
                if label == "ELL":
                    name = "spmv_ell" if nb == 1 else "spmv_ell_cols"
                    got = (local.matvec(x) if nb == 1 else local.matmat_rows(x))
                    want = spmv_ell.ell_matvec_plain(local.data, local.cols, x)
                    shape = f"({local.data.shape[0]}, L={local.data.shape[1]}) x {width}"
                else:
                    window = local.uses_window
                    name = ("spmv_bsr_window" if window else "spmv_bsr") + (
                        "" if nb == 1 else "_cols")
                    got = (local.matvec(x) if nb == 1 else local.matmat_rows(x))
                    want = (spmv_bsr.bsr_window_matvec_plain(local.blocks, local.window,
                                                             x, local.n_rows)
                            if window else spmv_bsr.bsr_matvec_plain(
                                local.blocks, local.block_cols, x, local.n_rows))
                    shape = (f"blocks {tuple(local.blocks.shape)} x {width}, "
                             f"{'window' if window else 'gather'} kernel")
                rec[name].check(f"{label} shard rank {rank} halo {halo.halo} {shape} "
                                f"b={nb}", torch.float64, got, want)
        del op, halo, local
    sync()
    for name in ("spmv_dia_ext", "spmv_dia_ext_cols"):
        print_time(name, rec[name])
        print_time(f"{name}:complex128", crec[name])
    return crec


def time_shard_form(r, wrap, local, x, nb, window, dev):
    """Time a DIA shard form on its block ``local`` against the halo
    window ``x`` (events, cold device time, host enqueue), beside its bound
    and cuSPARSE's CSR product of the shard's ``window`` (SciPy) in
    ``x``'s dtype."""
    from arnoldi_tpu_torch.ops.kernels import spmv_banded

    h = local.x_base

    def kernel(bands=local.bands, x=x):
        return wrap(bands, x, local.offsets, x_base=h)

    def plain():
        return spmv_banded.banded_matvec_ext_plain(local.bands, x, local.offsets,
                                                   x_base=h)

    r.time(kernel, plain, cold(kernel, local.bands, x), library_enqueue=True)
    n_local, item = local.bands.shape[1], x.element_size()
    r.set_bound((local.bands.numel() + nb * (2 * n_local + 2 * h)) * item,
                (8 if x.is_complex() else 2) * local.bands.numel() * nb)
    W = csr_tensor(window, x.dtype, dev)
    XT = x if nb == 1 else x.T.contiguous()

    def library(W=W, XT=XT):
        return W @ XT

    r.time_library(f"A_window_csr @ {'x' if nb == 1 else 'X'} "
                   f"(cuSPARSE Sp{'MV' if nb == 1 else 'MM'})", library,
                   plain() if nb == 1 else plain().T, cold(library, W, XT))


def check_bit_equal(label, got, want_T, got_mv, want_mv, limit=1e-12):
    import numpy as np

    got = host_array(got) if hasattr(got, "cpu") else np.asarray(got)
    diff = float(np.abs(got - want_T).max())
    print(f"  {label}: matvecs {got_mv} (expected {want_mv}); max |T - T_ref| "
          f"{diff:.3e} (limit {limit:g}; bit-equal: {diff == 0.0})")
    if not (got_mv == want_mv and diff <= limit):
        fail(f"{label} differs from its reference solve")
    return diff


def phase_one_rank_nccl(mats, counts, refs):
    """Phase 41: solve A's configuration through ``sharded_partial_schur``
    over a one-rank NCCL process group in this process, with the ring-halo
    DIA operator: the all-reduces are of one term, so it must repeat solve
    A (2900 matvecs, T within 1e-12)."""
    import torch
    import torch.distributed as dist

    from arnoldi_tpu_torch import as_operator
    from arnoldi_tpu_torch.parallel import halo_matvec_closure, make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        print(f"  mesh: {mesh.size} rank, backend {mesh.backend}, device {mesh.device}")
        A = mats["laplace"]
        op = halo_matvec_closure(as_operator(A, dtype=torch.float64, device="cuda"),
                                 mesh)
        print(f"  HaloOperator: halo {op.halo} rows, kernel {op.kernel}, "
              f"{op.exchange_bytes()} bytes exchanged a matvec")
        Q, T, hist, wall = solve("solve A, one-rank NCCL mesh", op, 5, "LM", 80, counts)
        check_laplace("solve A, one-rank NCCL mesh", A, Q, T, 724)
        diff = check_bit_equal("one-rank mesh against solve A", T, refs["A_T"],
                               hist.total_matvecs, refs["A_matvecs"])
        del Q, op
    finally:
        dist.destroy_process_group()
    return hist, wall, {"max_abs_dT": diff, "backend": "nccl"}


def mesh_rank_main(rank, size, port, refs, queue):
    """One rank of phases 42-44 (a spawned process, gloo over localhost,
    computing on the card the parent uses).  Puts ``(rank, results)`` on
    ``queue``; rank 0 checks each solve against its reference and prints."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator, partial_eigh, partial_schur
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import _build
    from arnoldi_tpu_torch.parallel import (gather_rows, halo_matvec_closure,
                                            make_mesh, shard_operator)
    from arnoldi_tpu_torch.parallel.multihost import initialize
    from arnoldi_tpu_torch.utils.checkpoint import (load_checkpoint_sharded,
                                                    save_checkpoint_sharded)

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", size, rank, backend="gloo")
    mesh = make_mesh(device="cuda")
    say = print if rank == 0 else (lambda *a, **k: None)
    _build.library()                        # the parent's build
    kernels.reset_launch_counts()
    out = {"launches": None, "solves": {}}

    def counts():
        sync()
        return kernels.launch_counts()

    def record(key, hist, wall, **more):
        out["solves"][key] = dict(matvecs=hist.total_matvecs,
                                  restarts=len(hist.residual_trace), wall_s=wall,
                                  phases=hist.phases, **more)

    def ks(label, op, nev, which, m, **kw):
        args = dict(max_dim=m, stopping_criterion=1e-8, sort_function=which,
                    dtype=torch.float64, ortho="cgs2", max_restarts=1000)
        args.update(kw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Q, T, hist = partial_schur(op, nev, **args)
        sync()
        wall = time.perf_counter() - t0
        say(f"  {label} ({size} ranks): wall {wall:.4f} s, matvecs "
            f"{hist.total_matvecs}, restarts {len(hist.residual_trace)}, "
            f"{1e3 * wall / hist.total_matvecs:.4f} ms/matvec")
        return gather_rows(Q, mesh), T, hist, wall

    def describe(label, op):
        say(f"  {label}: {type(op).__name__}, backend {mesh.backend}, kernel "
            f"{op.kernel}, {op.exchange_bytes()} bytes a rank receives a matvec")

    t_all = time.perf_counter()
    A = matrices.laplace_2d(724)
    dia = as_operator(A, dtype=torch.float64, device="cuda")
    say("phase 42: two ranks on the card over gloo (CUDA tensors into its "
        "all-reduce and all-gather, the ring exchange staged through pinned host "
        "buffers)")
    H = halo_matvec_closure(dia, mesh)
    describe("solve A, DIA halo", H)
    Q, T, hist, wall = ks("solve A, DIA halo", H, 5, "LM", 80)
    if rank == 0:
        check_laplace("solve A, 2-rank DIA halo", A, Q, T, 724)
        print(f"  matvecs {hist.total_matvecs} against solve A's {refs['A_matvecs']} "
              "on one card")
    record("A2", hist, wall, T=host_array(T))
    del Q

    S = scattered_matrix(2**20)
    ell = as_operator(S, dtype=torch.float64, device="cuda")
    for label, op in (("solve B, ELL halo", halo_matvec_closure(ell, mesh)),
                      ("solve B, all-gather", shard_operator(ell, mesh))):
        describe(label, op)
        Q, T, hist, wall = ks(label, op, 5, "LR", 40)
        if rank == 0:
            check_arpack(label, S, Q, T, refs["B"])
        record("B2_halo" if "halo" in label else "B2_gather", hist, wall)
        del Q, op
    bsr = as_operator(S, dtype=torch.float64, format=("bsr", (8, 8)), device="cuda")
    H = halo_matvec_closure(bsr, mesh)
    del bsr
    describe("solve C, BSR-8 halo", H)
    Q, T, hist, wall = ks("solve C, BSR-8 halo", H, 5, "LR", 40)
    if rank == 0:
        check_arpack("solve C, 2-rank BSR-8 halo", S, Q, T, refs["B"])
    record("C2", hist, wall, kernel=H.kernel)
    del Q, H

    H = halo_matvec_closure(dia, mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # cgs2: three all-reduces and one ring exchange a step (cgs_dgks takes
    # four and one where its second pass runs, most steps here)
    vals, V, hist = partial_eigh(H, 5, which="LA", max_dim=80, ortho="cgs2",
                                 stopping_criterion=1e-8, dtype=torch.float64)
    sync()
    wall = time.perf_counter() - t0
    say(f"  solve I, DIA halo ({size} ranks, partial_eigh, host loop): wall "
        f"{wall:.4f} s, matvecs {hist.total_matvecs}")
    V = gather_rows(V, mesh)
    if rank == 0:
        check_laplace_eigh("solve I, 2-rank DIA halo", A, vals, V, 724)
    record("I2", hist, wall)
    del V

    B9 = separated_banded(2**20)
    H9 = halo_matvec_closure(as_operator(B9, dtype=torch.float64, device="cuda"),
                             mesh)
    Q, T, hist, wall = ks(f"solve E9, the separated 9-band matrix, DIA halo, "
                          f"block_size={B_COLS}", H9, 5, "LR", 40,
                          block_size=B_COLS)
    if rank == 0:
        check_arpack("solve E9, 2-rank DIA halo, block", B9, Q, T, refs["E9"])
    record("E9", hist, wall)
    del Q, H9

    say("phase 43: solve M refined over the 2-rank ELL halo: float32 to 2e-4, "
        "then the float64 continuation on the halo operator's own values")
    H = halo_matvec_closure(ell, mesh)
    Q, T, hist, wall = ks("solve M, ELL halo", H, 5, "LR", 40, dtype=torch.float32)
    if rank == 0:
        if Q.dtype != torch.float64 or "refine.continue" not in hist.phases:
            fail("solve M over the mesh did not refine in float64")
        check_arpack("solve M, 2-rank ELL halo", S, Q, T, refs["B"])
    record("M2", hist, wall)
    del Q, H, ell

    say("phase 44: sharded checkpoint: solve A on 2 ranks cut at restart 50 "
        "(a snapshot every 25), resumed on 2 ranks")
    path = os.path.join(CHECKPOINT_DIR, "sharded_a.npz")
    if rank == 0:
        os.makedirs(CHECKPOINT_DIR, exist_ok=True)
        for fn in [path] + [f"{path}.p{k}" for k in range(8)]:
            if os.path.exists(fn):
                os.remove(fn)
    mesh.barrier()
    H = halo_matvec_closure(dia, mesh)
    try:
        ks("solve A cut", H, 5, "LM", 80, max_restarts=50, checkpoint_path=path,
           checkpoint_every=25)
    except ValueError as e:
        if "Has not converged" not in str(e):
            raise
    else:
        fail("solve A at max_restarts=50 should not have converged")
    files = {os.path.basename(fn): os.path.getsize(fn)
             for fn in [path, f"{path}.p0", f"{path}.p1"]}
    say(f"  snapshot files (bytes): {files}")
    # The solve's own writes raised with it; write the snapshot again from
    # host memory to time a save (this rank's shard, rank 0's metadata).
    ck = load_checkpoint_sharded(path, mesh)
    copy = path + ".copy.npz"
    t0 = time.perf_counter()
    save_checkpoint_sharded(copy, ck, mesh)
    rewrite = time.perf_counter() - t0
    os.remove(f"{copy}.p{rank}")
    if rank == 0:
        os.remove(copy)
    say(f"  writing it again from host memory (every rank its shard, a barrier): "
        f"{rewrite:.4f} s")
    del ck
    Q, T, hist, wall = ks("solve A resumed", H, 5, "LM", 80, resume=True,
                          checkpoint_path=path, checkpoint_every=10**6)
    record("A2_resumed", hist, wall, T=host_array(T), files=files,
           snapshot_rewrite_s=rewrite)
    del Q, H, dia
    out["launches"] = kernels.launch_counts()
    out["wall_s"] = time.perf_counter() - t_all
    mesh.barrier()
    queue.put((rank, out))
    import torch.distributed as dist

    dist.destroy_process_group()


def spawn_ranks(target, extra, label):
    """Spawn ``MESH_RANKS`` processes running ``target(rank, size, port,
    *extra, queue)`` and collect their ``(rank, results)``; fail if a rank
    fails or outlives ``PARALLEL_TIMEOUT_S`` (``label`` names the phases)."""
    import multiprocessing

    import torch

    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(rank, MESH_RANKS, port, *extra, queue))
             for rank in range(MESH_RANKS)]
    for p in procs:
        p.start()
    results, t0 = {}, time.perf_counter()
    try:
        while len(results) < MESH_RANKS:
            try:
                rank, out = queue.get(timeout=5)
                results[rank] = out
            except Exception:       # queue.Empty: look at the ranks
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    fail(f"a rank of {label} exited {dead[0].exitcode}")
                if time.perf_counter() - t0 > PARALLEL_TIMEOUT_S:
                    fail(f"{label} outlived {PARALLEL_TIMEOUT_S} s")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(MESH_RANKS)]


def phase_parallel(mats, counts, refs, references=None):
    """Phases 41-44 (the sharded path; the caller zeroes the counts before
    and reads them after): the one-rank NCCL mesh here, phases 42-44 in
    two spawned ranks, then this process resumes phase 44's snapshot on
    one rank.  ``references``: the reference worker's results, "E9" among
    them (computed here without it).  Returns ``(rows, extra, worker
    launches summed)``."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator, partial_schur
    from arnoldi_tpu_torch.parallel import make_mesh

    rows, extra = [], {}
    refs = dict(refs, E9=(reference(references, "E9") if references is not None
                          else complex_reference("E9", 2**20)[0]))
    print("phase 41: one-rank NCCL mesh in this process, solve A's configuration "
          "through sharded_partial_schur with the DIA halo")
    hist, wall, more = phase_one_rank_nccl(mats, counts, refs)
    rows.append(("A_nccl1", hist, wall))
    extra["A_nccl1"] = more

    t0 = time.perf_counter()
    ranks = spawn_ranks(mesh_rank_main, (refs,), "phases 42-44")
    print(f"  phases 42-44 in {MESH_RANKS} spawned ranks: {time.perf_counter() - t0:.2f} s "
          f"(ranks' own walls {[round(r['wall_s'], 2) for r in ranks]})")
    r0 = ranks[0]["solves"]
    for key in r0:
        per_rank = [r["solves"][key]["matvecs"] for r in ranks]
        if len(set(per_rank)) != 1:
            fail(f"{key}: the ranks counted different matvecs {per_rank}")
        print(f"  {key}: matvecs {per_rank[0]} on every rank, restarts "
              f"{r0[key]['restarts']}, wall {r0[key]['wall_s']:.4f} s")
    a2 = r0["A2"]
    check_bit_equal("the resumed 2-rank solve A against the unbroken one",
                    r0["A2_resumed"]["T"], a2["T"], r0["A2_resumed"]["matvecs"],
                    a2["matvecs"])
    print(f"  snapshot files {r0['A2_resumed']['files']}, written again from host "
          f"memory in {r0['A2_resumed']['snapshot_rewrite_s']:.4f} s")
    for key in ("A2", "B2_halo", "B2_gather", "C2", "I2", "E9", "M2", "A2_resumed"):
        s = r0[key]
        extra[key] = {"ranks": MESH_RANKS, "phases_rank0": s["phases"]}
        rows.append((key, _Hist(s["matvecs"], s["restarts"]), s["wall_s"]))
    extra["A2_resumed"].update(files=r0["A2_resumed"]["files"],
                               snapshot_rewrite_s=r0["A2_resumed"]["snapshot_rewrite_s"])
    extra["C2"]["kernel"] = r0["C2"]["kernel"]

    print("phase 44: the 2-rank snapshot resumed on one rank (mesh-elastic)")
    A = mats["laplace"]
    op = as_operator(A, dtype=torch.float64, device="cuda")
    path = os.path.join(CHECKPOINT_DIR, "sharded_a.npz")
    t0 = time.perf_counter()
    Q, T, hist = partial_schur(op, 5, mesh=make_mesh(), max_dim=80,
                               stopping_criterion=1e-8, sort_function="LM",
                               dtype=torch.float64, ortho="cgs2", max_restarts=1000,
                               resume=True, checkpoint_path=path,
                               checkpoint_every=10**6)
    sync()
    wall = time.perf_counter() - t0
    report_solve("solve A resumed on one rank", hist, wall, counts)
    check_laplace("solve A resumed on one rank", A, Q, T, 724)
    rows.append(("A1_elastic", hist, wall))
    for fn in [path] + [f"{path}.p{k}" for k in range(MESH_RANKS)]:
        os.remove(fn)
    del Q, op
    summed = {}
    for r in ranks:
        for name, v in r["launches"].items():
            summed[name] = summed.get(name, 0) + v
    print(f"  launches in the spawned ranks (summed): {summed}")
    return rows, extra, summed


# The sharded filter and the harness (phases 45-47): the filtered drivers'
# mesh= over the DIA and ELL halos at b = s, and the harness's CLIs.

#: The kernels phases 45-47 must launch (this process and the ranks).
FILTER_MESH_KERNELS = ("spmv_dia_ext_cols", "spmv_ell_cols", "spmv_dia_ext",
                       "masked_project", "project_update_norm")
#: The bytes a product moves at b = 297 on laplace_3d(64)'s 2-rank DIA
#: shard is the bound of the record "spmv_dia_ext_cols:filter".
FILTER_SHARD_B = 297


def nearest_check(label, vals, exact, window, k, A, V, scale):
    """Hold a nev-mode filtered solve: its values the k exact values
    nearest the window's center by distance (a tie is either value),
    within 1e-9, and ``||Av - lambda v|| / scale <= 1e-7``.  Returns the
    distance error."""
    import numpy as np

    want = nearest(exact, window, k)
    c = 0.5 * sum(window)
    err = float(np.abs(np.sort(np.abs(vals - c)) - np.sort(np.abs(want - c))).max())
    off = float(np.abs(vals[:, None] - exact[None, :]).min(axis=1).max())
    Vh = host_array(V)
    res = float((np.linalg.norm(A @ Vh - Vh * vals[None, :], axis=0)).max() / scale)
    print(f"  {label}: {len(vals)} values; distances to the center against the "
          f"{k} exact nearest: error {err:.3e}; each value to its exact one "
          f"{off:.3e} (limit 1e-9); residual / {scale} {res:.3e} (limit 1e-7)")
    if not (len(vals) == k and err <= 1e-9 and off <= 1e-9 and res <= 1e-7):
        fail(f"{label}: values or residual out of bounds")
    return max(err, off)


def filter_mesh_rank_main(rank, size, port, queue):
    """One rank of phase 46 (a spawned process, gloo over localhost,
    computing on the card the parent uses): (a) nev 10 of laplace_3d(64)
    in solve 32's window over the DIA halo and one sweep of it under the
    profiler, (b) solve 33's configuration over the ELL halo, (c) a KPM
    window count.  Puts ``(rank, results)`` on ``queue``; rank 0 checks the
    values and prints."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import as_operator, eigsh_filtered, matrices
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import _build
    from arnoldi_tpu_torch.parallel import gather_rows, halo_matvec_closure, make_mesh
    from arnoldi_tpu_torch.parallel.multihost import initialize
    from arnoldi_tpu_torch.solvers.filtered import estimate_window_count

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.set_device(0)
    initialize(f"127.0.0.1:{port}", size, rank, backend="gloo")
    mesh = make_mesh(device="cuda")
    say = print if rank == 0 else (lambda *a, **k: None)
    _build.library()                        # the parent's build
    kernels.reset_launch_counts()
    out = {"runs": {}}
    t_all = time.perf_counter()

    def run(key, label, op, fn):
        before = kernels.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        sync()
        ring0 = ring_time(mesh)
        t0 = time.perf_counter()
        vals, V, hist = fn()
        sync()
        wall = time.perf_counter() - t0
        ring = [b - a for a, b in zip(ring0, ring_time(mesh))]
        geo = hist.geometry
        launches = {k: v - before[k] for k, v in kernels.launch_counts().items()
                    if v != before[k]}
        nbytes = op.exchange_bytes(geo["s"])
        say(f"  {label} ({size} ranks): wall {wall:.4f} s, matvecs "
            f"{hist.total_matvecs}, s {geo['s']}, degree {geo['degree']}, sweeps "
            f"{geo['sweeps']} (float64 continuation {geo['f64_sweeps']} sweeps, "
            f"{geo['f64_matvecs']} matvecs), {nbytes} bytes a rank receives an "
            f"SpMV at b = s, the ring exchange {ring[0]:.4f} s of host time over "
            f"{ring[1]} exchanges, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB; phases " + "; ".join(f"{k} {v['seconds']:.3f} s x{v['calls']}"
                                        for k, v in sorted(hist.phases.items())))
        out["runs"][key] = dict(matvecs=hist.total_matvecs, s=geo["s"],
                                degree=geo["degree"], sweeps=geo["sweeps"],
                                f64_matvecs=geo["f64_matvecs"], wall_s=wall,
                                bytes_per_spmv=nbytes, exchange_host_s=ring[0],
                                exchanges=ring[1], launches=launches,
                                geometry=geo, phases=hist.phases)
        return vals, gather_rows(V, mesh), hist

    say("phase 46: two ranks on the card over gloo: the filtered drivers over "
        "the DIA and ELL halos")
    A64 = matrices.laplace_3d(64)
    H = halo_matvec_closure(as_operator(A64, dtype=torch.float64, device="cuda"),
                            mesh)
    say(f"  DIA halo: {H.halo} rows, kernel {H.kernel}, {H.n_local} rows a rank")
    vals, V, hist = run("46a", "(a) eigsh_filtered(laplace_3d(64), nev=10, "
                        f"{FILTER_WINDOW_64}, tol=1e-8), float64, DIA halo", H,
                        lambda: eigsh_filtered(
                            H, 10, FILTER_WINDOW_64, tol=1e-8,
                            generator=torch.Generator().manual_seed(0)))
    if rank == 0:
        lmin, lmax = hist.geometry["bounds"]
        nearest_check("(a)", vals, np.sort(matrices.laplace_3d_eigen(64)),
                      FILTER_WINDOW_64, 10, A64, V, max(abs(lmin), abs(lmax)))
    del V
    # no warm-up sweep: run (a) has just run this one's shapes
    out["sweep"] = filter_sweep_split(H, hist.geometry, mesh, warm=False)

    A48 = matrices.laplace_3d(48)
    H48 = halo_matvec_closure(as_operator(A48, format="ell", device="cuda"), mesh)
    say(f"  ELL halo: {H48.halo} rows, kernel {H48.kernel}, window "
        f"{H48.local.shape[1]} columns")
    vals, V, hist = run("46b", "(b) eigsh_filtered(laplace_3d(48) as ELL, nev=10, "
                        f"{FILTER_WINDOW_48}, tol=1e-8), float32 then float64, "
                        "ELL halo", H48,
                        lambda: eigsh_filtered(
                            H48, 10, FILTER_WINDOW_48, tol=1e-8, dtype=torch.float32,
                            generator=torch.Generator().manual_seed(1)))
    if rank == 0:
        if V.dtype != torch.float64 or hist.geometry["f64_matvecs"] == 0:
            fail("(b) did not continue in float64")
        lmin, lmax = hist.geometry["bounds"]
        nearest_check("(b)", vals, np.sort(matrices.laplace_3d_eigen(48)),
                      FILTER_WINDOW_48, 10, A48, V, max(abs(lmin), abs(lmax)))
    del V, H48

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    count = estimate_window_count(H, FILTER_WINDOW_64,
                                  generator=torch.Generator().manual_seed(5))
    out["count"] = count
    out["count_wall_s"] = time.perf_counter() - t0
    out["count_launches"] = {k: v - before[k] for k, v in
                             kernels.launch_counts().items() if v != before[k]}
    out["launches"] = kernels.launch_counts()
    out["wall_s"] = time.perf_counter() - t_all
    mesh.barrier()
    queue.put((rank, out))
    import torch.distributed as dist

    dist.destroy_process_group()


def phase_filtered_mesh(mats, refs):
    """Phases 45 and 46 (the caller zeroes the counts before): solve 32's
    configuration through ``eigsh_window(mesh=)`` on a one-rank NCCL mesh
    in this process over the DIA halo (it must count solve 32's matvecs,
    its values within 1e-12 of solve 32's: ``refs["values_32"]``,
    ``refs["matvecs_32"]``), then phase 46 in two spawned ranks.  Returns
    ``(rows, extra, the ranks' launches summed, widths)``: ``widths`` the
    s of phase 45's slices and of runs 46(a) and 46(b)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from arnoldi_tpu_torch import as_operator, eigsh_window
    from arnoldi_tpu_torch.parallel import halo_matvec_closure, make_mesh
    from arnoldi_tpu_torch.solvers.filtered import estimate_window_count

    rows, extra = [], {}
    A = mats["laplace3d64"]
    print(f"phase 45: eigsh_window(laplace_3d(64), {FILTER_WINDOW_64}, tol=1e-8, "
          "mesh=) on a one-rank NCCL mesh in this process, over the DIA halo")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        H = halo_matvec_closure(as_operator(A, dtype=torch.float64, device="cuda"),
                                mesh)
        print(f"  mesh: {mesh.size} rank, backend {mesh.backend}; HaloOperator: "
              f"halo {H.halo} rows, kernel {H.kernel}")
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        vals, V, hist = eigsh_window(H, FILTER_WINDOW_64, tol=1e-8,
                                     generator=torch.Generator().manual_seed(0))
        sync()
        wall = time.perf_counter() - t0
        print(f"  wall {wall:.4f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print_filter_history(hist)
        want = refs["values_32"]
        diff = (float(np.abs(vals - want).max()) if len(vals) == len(want)
                else float("inf"))
        print(f"  against solve 32: matvecs {hist.total_matvecs} (solve 32: "
              f"{refs['matvecs_32']}), {len(vals)} values (solve 32: {len(want)}), "
              f"max |lambda - lambda_32| {diff:.3e} (limit 1e-12; bit-equal: "
              f"{diff == 0.0})")
        if not (hist.total_matvecs == refs["matvecs_32"] and diff <= 1e-12):
            fail("phase 45 differs from solve 32")
        rows.append(("45", hist, wall))
        extra["45"] = {"max_abs_d_lambda": diff, "backend": "nccl",
                       "slices": [{k: g[k] for k in ("interval", "s", "degree",
                                                     "sweeps")}
                                  for g in hist.slices], "phases": hist.phases}
        widths = {"45": sorted({g["s"] for g in hist.slices})}
        del V, H
    finally:
        dist.destroy_process_group()
    one = estimate_window_count(as_operator(A, dtype=torch.float64, device="cuda"),
                                FILTER_WINDOW_64,
                                generator=torch.Generator().manual_seed(5))

    t0 = time.perf_counter()
    ranks = spawn_ranks(filter_mesh_rank_main, (), "phase 46")
    print(f"  phase 46 in {MESH_RANKS} spawned ranks: {time.perf_counter() - t0:.2f} s "
          f"(ranks' own walls {[round(r['wall_s'], 2) for r in ranks]})")
    for key in ("46a", "46b"):
        per_rank = [r["runs"][key]["matvecs"] for r in ranks]
        if len(set(per_rank)) != 1:
            fail(f"{key}: the ranks counted different matvecs {per_rank}")
        r0 = ranks[0]["runs"][key]
        print(f"  {key}: matvecs {per_rank[0]} on every rank, s {r0['s']}, degree "
              f"{r0['degree']}, sweeps {r0['sweeps']}, {r0['bytes_per_spmv']} bytes "
              f"a rank receives an SpMV; launches by rank "
              f"{[r['runs'][key]['launches'] for r in ranks]}")
        rows.append((key, _Hist(r0["matvecs"], r0["sweeps"]), r0["wall_s"]))
        extra[key] = {k: r0[k] for k in ("s", "degree", "sweeps", "f64_matvecs",
                                         "bytes_per_spmv", "exchange_host_s",
                                         "exchanges", "phases")}
        extra[key].update(ranks=MESH_RANKS,
                          launches_by_rank=[r["runs"][key]["launches"] for r in ranks])
        widths[key] = r0["s"]
    two = [r["count"] for r in ranks]
    rel = abs(two[0] - one) / abs(one)
    print(f"  (c) estimate_window_count({FILTER_WINDOW_64}): {two} on 2 ranks, "
          f"{one} on one: relative difference {rel:.3e} (limit 1e-10); "
          f"{ranks[0]['count_wall_s']:.3f} s, launches by rank "
          f"{[r['count_launches'] for r in ranks]}")
    if not (two[0] == two[1] and rel <= 1e-10):
        fail("(c) the 2-rank KPM count disagrees")
    extra["46c"] = {"count_2": two[0], "count_1": one, "rel": rel}
    extra["46a"]["sweep"] = ranks[0]["sweep"]
    summed = {}
    for r in ranks:
        for name, v in r["launches"].items():
            summed[name] = summed.get(name, 0) + v
    print(f"  launches in the spawned ranks (summed): {summed}")
    return rows, extra, summed, widths


def phase_filter_shard_kernels(mats, widths, gen, device="cuda"):
    """Before phase 47 (outside the counted windows): ``spmv_dia_ext_cols``
    on laplace_3d(64)'s 2-rank DIA shard (131,072 rows against a 139,264
    window, h = 4096) at phase 45's and 46(a)'s s and at b = 297 against
    its plain version, every column bit for bit against the single-column
    kernel, timed at b = 297 (phase 45's widest slice: record
    ``spmv_dia_ext_cols:filter``) and at 46(a)'s s (``:filter_46a``):
    events, cold device time, the bound, cuSPARSE's SpMM of the window's
    CSR; ``spmv_ell_cols`` on laplace_3d(48)'s 2-rank ELL shard (the
    rectangular column map of the halo) at 46(b)'s s in float64 and float32
    against its plain version, every column bit for bit against the
    single-column kernel, timed in both (``spmv_ell_cols:halo_f64``,
    ``:halo``) the same way.  Returns ``{record name: KernelRecord}``."""
    import torch

    from arnoldi_tpu_torch.linop import BandedOperator, EllOperator, cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_banded, spmv_ell
    from arnoldi_tpu_torch.parallel import Mesh, halo_matvec_closure

    dev = torch.device(device)
    recs = {}
    A = mats["laplace3d64"]
    rank = 1
    local = halo_matvec_closure(BandedOperator.from_scipy(A, device=dev),
                                Mesh(None, rank, MESH_RANKS, dev)).local
    h, n_local = local.x_base, local.bands.shape[1]
    timed = {FILTER_SHARD_B: "spmv_dia_ext_cols:filter"}
    timed.setdefault(widths["46a"], "spmv_dia_ext_cols:filter_46a")
    for nb in sorted({*widths["45"], widths["46a"], FILTER_SHARD_B}):
        r = KernelRecord()
        if nb in timed:
            recs[timed[nb]] = r
            r.b = nb
        x = torch.randn(nb, n_local + 2 * h, generator=gen, device=dev,
                        dtype=torch.float64)
        got = spmv_banded.banded_matmat_ext(local.bands, x, local.offsets, x_base=h)
        r.check(f"DIA shard (7, {n_local}) x {n_local + 2 * h} b={nb}",
                torch.float64, got,
                spmv_banded.banded_matvec_ext_plain(local.bands, x, local.offsets,
                                                    x_base=h))
        single = torch.stack([spmv_banded.banded_matvec_ext(
            local.bands, x[j], local.offsets, x_base=h) for j in range(nb)])
        if not torch.equal(got, single):
            fail(f"spmv_dia_ext_cols b={nb}: a column differs from the "
                 "single-column kernel")
        del got, single
        if nb in timed:
            row0 = rank * n_local
            time_shard_form(r, spmv_banded.banded_matmat_ext, local, x, nb,
                            shard_window_csr(A, row0, row0 + n_local, h), dev)
        del x
    del local

    A = mats["laplace3d48"]
    halo = halo_matvec_closure(EllOperator.from_scipy(A, device=dev),
                               Mesh(None, rank, MESH_RANKS, dev))
    nb = widths["46b"]
    for dtype, name in ((torch.float64, "spmv_ell_cols:halo_f64"),
                        (torch.float32, "spmv_ell_cols:halo")):
        r = recs[name] = KernelRecord(dtype)
        r.b = nb
        loc = cast_operator(halo.local, dtype)
        n_rows, width = loc.shape
        X = torch.randn(nb, width, generator=gen, device=dev, dtype=dtype)
        Y = loc.matmat_rows(X)
        r.check(f"ELL shard ({n_rows}, L={loc.data.shape[1]}) x {width} b={nb}",
                dtype, Y, ell_plain(loc.data, loc.cols, X))
        ell_columns_single(f"spmv_ell_cols halo b={nb} {dtype}", loc.data,
                           loc.cols, X, Y)
        del Y

        def kernel(data=loc.data, cols=loc.cols, X=X):
            return spmv_ell.ell_matmat(data, cols, X)

        def plain():
            return ell_plain(loc.data, loc.cols, X)

        r.time(kernel, plain, cold(kernel, loc.data, loc.cols, X))
        r.set_bound(ell_bytes(loc, nb), 2 * loc.nnz * nb)
        row0 = rank * n_rows
        W = csr_tensor(shard_window_csr(A, row0, row0 + n_rows, halo.halo),
                       dtype, dev)
        XT = X.T.contiguous()

        def library(W=W, XT=XT):
            return W @ XT

        r.time_library(f"A_window_csr @ X (cuSPARSE SpMM, b={nb})", library,
                       plain().T, cold(library, W, XT))
        del W, XT, X, loc
    sync()
    for name, rec in recs.items():
        print_time(name, rec)
    return recs


def phase_harness():
    """Phase 47: the harness's CLIs on the card, each printing what it
    prints: ``bench_partial_schur laplace2d:300 --which LM`` (the device
    path, ARPACK beside it), ``stress_test --quick laplace2d:200``,
    ``compare_arpack mark:100`` (the host tier) and ``scaling_bench`` on 1
    and 2 gloo ranks over laplace_2d(724)'s DIA halo; the stress rows whose
    match is not True are settled (:func:`settle_stress_rows`).  Returns
    ``({label: summary}, the scaling ranks' launches summed)``."""
    import csv

    from arnoldi_tpu_torch.harness import (bench_partial_schur, compare_arpack,
                                           scaling_bench, stress_test)

    extra = {}
    for label, run in (
            ("bench_partial_schur", lambda: bench_partial_schur.main(
                ["laplace2d:300", "--which", "LM"])),
            ("compare_arpack", lambda: compare_arpack.main(["mark:100"]))):
        print(f"  $ python -m arnoldi_tpu_torch.harness.{label} ...")
        t0 = time.perf_counter()
        if run() != 0:
            fail(f"{label} exited nonzero")
        extra[label] = {"wall_s": time.perf_counter() - t0}
    out = os.path.join(CHECKPOINT_DIR, "stress.csv")
    os.makedirs(CHECKPOINT_DIR, exist_ok=True)
    print("  $ python -m arnoldi_tpu_torch.harness.stress_test laplace2d:200 --quick")
    t0 = time.perf_counter()
    if stress_test.main(["laplace2d:200", "--quick", "-o", out]) != 0:
        fail("stress_test exited nonzero")
    with open(out) as f:
        rows = list(csv.reader(f))
    os.remove(out)
    for row in rows:
        print("    " + ",".join(row))
    if any(r[8] == "-1" for r in rows[1:]):
        fail("stress_test: a method failed")
    extra["stress_test"] = {"wall_s": time.perf_counter() - t0, "rows": rows[1:],
                            "settled": settle_stress_rows(rows)}
    print("  $ python -m arnoldi_tpu_torch.harness.scaling_bench --grid 724 "
          "--ranks 1,2 (float64; two ranks on the card run gloo)")
    t0 = time.perf_counter()
    scaling = scaling_bench.run_scaling(n_grid=724, rank_counts=(1, MESH_RANKS),
                                        dtype="float64", device="cuda")
    print(json.dumps(scaling, indent=2))
    extra["scaling_bench"] = {"wall_s": time.perf_counter() - t0, "rows": scaling}
    summed = {}
    for row in scaling:
        for name, v in row["launches"].items():
            summed[name] = summed.get(name, 0) + v
    return extra, summed


def settle_stress_rows(rows):
    """Settle each grid row of ``stress_test --quick laplace2d:200`` whose
    match is not True against laplace_2d(200)'s exact spectrum: the row's
    methods solve again from the row's start vector (seed 0) and each must
    settle as "wanted" or "copies missed" (:func:`settle_with_spectrum`);
    fails otherwise, and for a row whose match is neither True nor False.
    Returns ``{"which nev ncv": {method: settlement}}``."""
    import numpy as np

    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.harness import matrix_from_spec, stress_test
    from arnoldi_tpu_torch.harness.suite import settle_with_spectrum

    header, body = rows[0], rows[1:]
    col = {name: i for i, name in enumerate(header)}
    settled, A, exact = {}, None, None
    for r in body:
        if r[col["match"]] == "True":
            continue
        if r[col["match"]] != "False":
            fail(f"stress_test: row {r} has match {r[col['match']]}")
        nev, ncv, which = int(r[col["nev"]]), int(r[col["ncv"]]), r[col["which"]]
        label = f"{which} nev {nev} ncv {ncv}"
        if label in settled:
            continue
        if A is None:
            A = matrix_from_spec("laplace2d:200")
            exact = matrices.laplace_2d_eigen(200)
        params = next(p for p in stress_test.QUICK_PARAMETERS
                      if (p.nev, p.ncv, p.which) == (nev, ncv, which))
        settled[label] = {}
        for method in sorted({b[col["method"]] for b in body}):
            vals = np.sort(np.real(np.asarray(
                stress_test.run_one(method, A, params, 0, "cuda")[0])))[::-1]
            how = settle_with_spectrum(vals, exact, which)
            settled[label][method] = how
            print(f"    {label}: {method} against laplace_2d(200)'s exact "
                  f"spectrum: {how}; values {vals.tolist()}")
            if how is None:
                fail(f"stress_test {label}: {method}'s values are not the "
                     "wanted eigenvalues, with or without their copies")
    return settled


class _Hist:
    """A spawned rank's solve counts, read as a History is read."""

    def __init__(self, matvecs, restarts):
        self.total_matvecs = matvecs
        self.residual_trace = [0.0] * restarts


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.environ["ARNOLDI_PHASES"] = "1"   # the tier checks read the phases

    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.native import dense_tier as native_dense_tier
    from arnoldi_tpu_torch.native import host_engine
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
        "scattered": scattered_matrix(2**20),
        "mark": matrices.mark(1000),
        "rect": rectangular(200_000, 300_000, max_degree=60, seed=0),
        "window": window_matrix(2**20),
        "reflect": reflected_scattered(2**20),
        "window_reflect": reflected_scattered(2**18, seed=2, bandwidth=1024),
    }
    mats["symmetric"] = ((mats["reflect"] + mats["reflect"].T) / 2).tocsr()
    mats["gauge"], mats["gauge_g"] = gauge_rotated(mats["laplace"])
    mats["gauge200"] = gauge_rotated(matrices.laplace_2d(200))[0]
    mats["phased"] = phased(mats["scattered"])
    mats["phased_window"] = phased(mats["window"])
    mats["phased_window_reflect"] = phased(reflected_scattered(2**20, seed=2,
                                                               bandwidth=1024))
    mats["phased_reflect"] = phased(mats["reflect"])
    mats["hermitian"] = hermitian_part(mats["phased_reflect"])
    mats["mark_phased"] = phased(matrices.mark(100))
    mats["laplace300"] = matrices.laplace_2d(300)
    mats["mass"] = lumped_mass(mats["laplace"].shape[0])
    mats["laplace3d64"] = matrices.laplace_3d(64)
    mats["laplace3d48"] = matrices.laplace_3d(48)
    print(f"  host matrices built in {time.perf_counter() - t0:.2f} s")
    pool, references = start_references(2**20, 724)
    try:
        run_phases(mats, references, smi)
        pool.close()
    finally:
        pool.terminate()
        pool.join()


def run_phases(mats, references, smi):
    """Phases 1-47 and the report (``main`` builds the matrices and starts
    the complex solves' ARPACK references)."""
    import torch

    from arnoldi_tpu_torch import as_operator
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    print("phase 1: kernels against their plain PyTorch versions")
    t0 = time.perf_counter()
    rec = phase_kernels(mats)
    crec = phase_complex_kernels(mats, torch.Generator(device="cuda").manual_seed(2))
    brec, window_plans = phase_complex_bsr_kernels(
        mats, torch.Generator(device="cuda").manual_seed(5))
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
    T_a = host_array(T)
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

    refs = {"B": ref_b, "B_matvecs": hist_b.total_matvecs,
            "A_matvecs": hist_a.total_matvecs,
            "A_restarts": len(hist_a.residual_trace), "A_T": T_a}
    hermitian = phase_hermitian(mats, counts, refs)

    final, final_dtypes = counts(), kernels.dtype_launch_counts()
    # The DIA shard form runs on the sharded path (phases 41-44) alone.
    missing = [k for k, v in final.items() if v == 0
               and k not in ("spmv_dia_ext", "spmv_dia_ext_cols")]
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

    # The complex path, counted on its own.
    kernels.reset_launch_counts()
    complex_rows, complex_extra = phase_complex(mats, references, counts,
                                                kernels.dtype_launch_counts, refs)
    complex_counts, complex_dtypes = counts(), kernels.dtype_launch_counts()
    idle = [f"{name}:{tag}" for tag, names in COMPLEX_PATH.items()
            for name in names if complex_dtypes[name].get(tag, 0) == 0]
    if idle:
        fail(f"complex forms never launched on the complex path (phases 19-25): {idle}")
    print(f"launches on the complex path (phases 19-25): {complex_dtypes}")

    # The shift-invert path, counted on its own.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    si_rows, si_extra = phase_shift_invert(mats, references, counts, refs)
    si_wall = time.perf_counter() - t0
    si_counts = counts()
    idle = [k for k in ("spmv_dia", "spmv_ell", "masked_project",
                        "project_update_norm") if si_counts[k] == 0]
    if idle:
        fail(f"kernels of phases 26-31 never launched there: {idle}")
    print(f"launches on the shift-invert path (phases 26-31): {si_counts}")
    print(f"phases 26-31 wall {si_wall:.2f} s")

    # The filtered and explicit-restart path, counted on its own.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    f_rows, f_extra, widths = phase_filtered(mats, references,
                                             kernels.dtype_launch_counts, refs)
    f_wall = time.perf_counter() - t0
    f_counts, f_dtypes = counts(), kernels.dtype_launch_counts()
    idle = [f"{name}:{tag}" for name, tag in (
        ("spmv_dia_cols", "float64"), ("spmv_ell_cols", "float32"),
        ("spmv_ell_cols", "float64"), ("spmv_dia", "float64"),
        ("spmv_ell", "float32"), ("masked_project", "float64"),
        ("project_update_norm", "float64"))
        if f_dtypes[name].get(tag, 0) == 0]
    if idle:
        fail(f"kernels of phases 32-34 never launched there: {idle}")
    print(f"launches on the filtered and explicit-restart path (phases 32-34): "
          f"{f_dtypes}")
    print(f"phases 32-34 wall {f_wall:.2f} s")
    print("phase 1 at the filter's widths (after phase 34, outside the counted "
          "windows)")
    frec = phase_filter_kernels(mats, widths, torch.Generator(device="cuda").manual_seed(4))
    f_extra["32"]["sweep"] = filter_sweep_split(
        as_operator(mats["laplace3d64"], dtype=torch.float64, device="cuda"),
        widths["geometry"])
    f_extra["33"]["sweep"] = filter_sweep_split(
        as_operator(mats["laplace3d48"], format="ell", dtype=torch.float32,
                    device="cuda"), widths["geometry_33"])

    # The complex BSR path and checkpoint/resume, counted on their own.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    b_rows, b_extra = phase_complex_bsr(mats, references, counts,
                                        kernels.dtype_launch_counts, refs)
    b_wall = time.perf_counter() - t0
    b_counts, b_dtypes = counts(), kernels.dtype_launch_counts()
    idle = [f"{name}:{tag}" for tag, names in COMPLEX_BSR_PATH.items()
            for name in names if b_dtypes[name].get(tag, 0) == 0]
    if idle:
        fail(f"complex BSR forms never launched on phases 35-39: {idle}")
    print(f"launches on the complex BSR and checkpoint path (phases 35-39): {b_dtypes}")
    print(f"phases 35-39 wall {b_wall:.2f} s")

    print("phase 40: the DIA shard form and the ELL/BSR shards against their plain "
          "versions (not counted)")
    t0 = time.perf_counter()
    shard_crec = phase_shard_kernels(mats, rec,
                                     torch.Generator(device="cuda").manual_seed(6))
    print(f"  phase 40 wall {time.perf_counter() - t0:.2f} s")

    # The sharded path, counted on its own: this process and the ranks.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    p_rows, p_extra, rank_counts = phase_parallel(mats, counts, refs, references)
    p_wall = time.perf_counter() - t0
    p_counts = {name: v + rank_counts.get(name, 0) for name, v in counts().items()}
    p_dtypes = kernels.dtype_launch_counts()   # this process's (the ranks' are float64)
    bsr_halo = p_extra["C2"]["kernel"]
    idle = [k for k in PARALLEL_KERNELS + (bsr_halo,) if p_counts[k] == 0]
    if idle:
        fail(f"kernels of phases 41-44 never launched there: {idle}")
    print(f"launches on the sharded path (phases 41-44, this process and the "
          f"ranks): {p_counts}")
    print(f"phases 41-44 wall {p_wall:.2f} s")

    # The sharded filter (phases 45-46) and the harness (phase 47), counted
    # on their own: this process and the ranks; the kernel checks between
    # phases 46 and 47 fall outside the count.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fm_rows, fm_extra, fm_rank_counts, fm_widths = phase_filtered_mesh(mats, widths)
    fm_counts = {name: v + fm_rank_counts.get(name, 0)
                 for name, v in counts().items()}
    print(f"phases 45-46 wall {time.perf_counter() - t0:.2f} s")
    print("the DIA and ELL halo shard forms at b = s against their plain versions "
          "(not counted)")
    t0 = time.perf_counter()
    fm_rec = phase_filter_shard_kernels(mats, fm_widths,
                                        torch.Generator(device="cuda").manual_seed(7))
    print(f"  wall {time.perf_counter() - t0:.2f} s")
    print("phase 47: the harness on the card")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    h_extra, h_rank_counts = phase_harness()
    print(f"phase 47 wall {time.perf_counter() - t0:.2f} s")
    h_counts = {name: v + h_rank_counts.get(name, 0) for name, v in counts().items()}
    fm_all = {name: fm_counts[name] + h_counts[name] for name in fm_counts}
    idle = [k for k in FILTER_MESH_KERNELS if fm_all[k] == 0]
    if idle:
        fail(f"kernels of phases 45-47 never launched there: {idle}")
    print(f"launches on the sharded filter and the harness (phases 45-47, this "
          f"process and the ranks): {fm_all}")

    summary = {label: {"matvecs": h.total_matvecs, "restarts": len(h.residual_trace),
                       "wall_s": w, "ms_per_matvec": 1e3 * w / h.total_matvecs}
               for label, h, w in (("A", hist_a, wall_a), ("B", hist_b, wall_b),
                                   ("C", hist_c, wall_c), ("D", hist_d, wall_d),
                                   ("E", hist_e, wall_e), ("F", hist_f, wall_f),
                                   ("G", hist_g, wall_g), ("H", hist_h, wall_h),
                                   *hermitian, *refined, *complex_rows,
                                   *si_rows, *f_rows, *b_rows, *p_rows,
                                   *fm_rows)}
    for label, fields in {**extra, **complex_extra, **si_extra, **f_extra,
                          **b_extra, **p_extra, **fm_extra, **h_extra}.items():
        summary.setdefault(label, {}).update(fields)
    print(f"solves: {json.dumps(summary)}")
    print(f"card: {smi}")

    # "launches": the main path's (phases 2-13); for the DIA shard form,
    # which runs on the sharded path alone, phases 41-44's.
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": (p_counts[name] if name in ("spmv_dia_ext", "spmv_dia_ext_cols")
                      else final[name]),
         "max_abs_err": rec[name].max_abs_err,
         "ms": rec[name].ms, "plain_ms": rec[name].plain_ms,
         "bound_ms": rec[name].bound_ms, "bound_by": rec[name].bound_by,
         "library_ms": rec[name].library_ms, "dev_ms": rec[name].dev_ms,
         "library_dev_ms": rec[name].library_dev_ms,
         "enqueue_us": rec[name].enqueue_us,
         "library_enqueue_us": rec[name].library_enqueue_us,
         "launches_phases_14_17": refine_path[name], "dtypes": final_dtypes[name],
         "launches_phases_19_25": complex_counts[name],
         "dtypes_phases_19_25": complex_dtypes[name],
         "launches_phases_26_31": si_counts[name],
         "launches_phases_32_34": f_counts[name],
         "dtypes_phases_32_34": f_dtypes[name],
         "launches_phases_35_39": b_counts[name],
         "dtypes_phases_35_39": b_dtypes[name],
         "launches_phases_41_44": p_counts[name],
         "launches_phases_45_47": fm_all[name]}
        for name, (_, source, replaces) in kernels.KERNELS.items()]}
    # The complex forms, each with its own record: "launches" counts the
    # complex path's launches in its dtype.
    report["kernels"] += [
        {"name": f"{name}:{tag}", "route": "cuda", "source": kernels.KERNELS[name][1],
         "replaces": kernels.KERNELS[name][2], "dtype": tag,
         "launches": complex_dtypes[name].get(tag, 0), "max_abs_err": r.max_abs_err,
         "ms": r.ms, "plain_ms": r.plain_ms, "bound_ms": r.bound_ms,
         "bound_by": r.bound_by, "library_ms": r.library_ms, "dev_ms": r.dev_ms,
         "library_dev_ms": r.library_dev_ms, "library": r.library,
         "enqueue_us": r.enqueue_us, "library_enqueue_us": r.library_enqueue_us}
        for (name, tag), r in crec.items()]
    # The complex128 shard forms (phase 40): "launches" counts phases
    # 41-44's in complex128 (the sharded solves run float64).
    report["kernels"] += [
        {"name": f"{name}:complex128", "route": "cuda",
         "source": kernels.KERNELS[name][1], "replaces": kernels.KERNELS[name][2],
         "dtype": "complex128", "launches": p_dtypes[name].get("complex128", 0),
         "max_abs_err": r.max_abs_err, "ms": r.ms, "plain_ms": r.plain_ms,
         "bound_ms": r.bound_ms, "bound_by": r.bound_by, "library_ms": r.library_ms,
         "dev_ms": r.dev_ms, "library_dev_ms": r.library_dev_ms, "library": r.library,
         "enqueue_us": r.enqueue_us, "library_enqueue_us": r.library_enqueue_us}
        for name, r in shard_crec.items()]
    # The complex BSR forms: "launches" counts phases 35-39's in the dtype.
    report["kernels"] += [
        {"name": f"{name}:{tag}", "route": "cuda", "source": kernels.KERNELS[name][1],
         "replaces": kernels.KERNELS[name][2], "dtype": tag,
         "launches": b_dtypes[name].get(tag, 0), "max_abs_err": r.max_abs_err,
         "ms": r.ms, "plain_ms": r.plain_ms, "bound_ms": r.bound_ms,
         "bound_by": r.bound_by, "library_ms": r.library_ms, "dev_ms": r.dev_ms,
         "library_dev_ms": r.library_dev_ms, "library": r.library,
         **({"window_plans": window_plans} if name == "spmv_bsr_window_cols"
            and tag == "complex128" else {})}
        for (name, tag), r in brec.items()]
    # The b-column forms at the filter's widths (phases 32-33): "launches"
    # counts phases 32-34's launches in the record's dtype.
    report["kernels"] += [
        {"name": name, "route": "cuda", "source": kernels.KERNELS[base][1],
         "replaces": kernels.KERNELS[base][2], "dtype": str(r.dtype).removeprefix("torch."),
         "launches": f_dtypes[base].get(str(r.dtype).removeprefix("torch."), 0),
         "max_abs_err": r.max_abs_err, "ms": r.ms, "plain_ms": r.plain_ms,
         "bound_ms": r.bound_ms, "bound_by": r.bound_by, "library_ms": r.library_ms,
         "dev_ms": r.dev_ms, "library_dev_ms": r.library_dev_ms, "library": r.library,
         "enqueue_us": r.enqueue_us, "library_enqueue_us": r.library_enqueue_us}
        for name, r in frec.items() for base in (name.split(":")[0],)]
    # The halo shard forms at b = s (phases 45-46): "launches" counts phases
    # 45-46's (this process and the ranks).
    report["kernels"] += [
        {"name": name, "route": "cuda", "source": kernels.KERNELS[base][1],
         "replaces": kernels.KERNELS[base][2], "dtype": str(r.dtype).removeprefix("torch."),
         "launches": fm_counts[base], "max_abs_err": r.max_abs_err, "ms": r.ms,
         "plain_ms": r.plain_ms, "bound_ms": r.bound_ms, "bound_by": r.bound_by,
         "library_ms": r.library_ms, "dev_ms": r.dev_ms,
         "library_dev_ms": r.library_dev_ms, "library": r.library,
         "enqueue_us": r.enqueue_us, "library_enqueue_us": r.library_enqueue_us,
         "b": r.b}
        for name, r in fm_rec.items() for base in (name.split(":")[0],)]
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
