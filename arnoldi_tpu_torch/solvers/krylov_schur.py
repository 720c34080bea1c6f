"""Krylov-Schur restarted eigensolver, scalar and block, on a device or on
the host tier.

Counterpart of ``partial_schur`` in ``arnoldi_tpu/solvers/krylov_schur.py``
(lines 541-897): repeat [Arnoldi expand to m | ordered Schur of the
projected H on the host | truncate the basis to p rows carrying the
residual vector | test ``|h_{m+1,m} q_{m,i}| / |t_ii| < tol``].  With
``block_size = b > 1`` the expansion takes b vectors a step (the operator's
b-column kernels and ``block_cgs2``), the residual is a block of b rows,
and the residual estimates are norms of the b coupling rows.

Everything n-sized (the expansion and the truncation gemm) runs on the
operator's device; everything m-sized runs on the host in float64 through
the port's copy of the JAX package's NumPy/C++ dense tier
(``ops/dense_tier.py``, ``native/dense_tier.cpp``), with only the
small H crossing the boundary once per restart.  A real operator runs in the
real work dtype with the real Schur form (2x2 blocks for conjugate pairs),
as the TPU path and the host tier do.  A complex operator, a complex
``dtype=`` or a complex ``v0`` makes the work dtype complex: the complex
Schur form (triangular T, no 2x2 blocks), the complex forms of the kernels,
and on the host tier complex128 NumPy.

Small SciPy/NumPy float64 or complex128 problems (n <= 32768, or any n
when the target device is the CPU) run the whole solve on the host tier
instead (``workspace.HostWorkspace``, :func:`~.workspace.uses_host_tier`),
as the JAX package does, and return their results on the requested device.

A float32 solve below tol 1e-6 is refined as the JAX package refines it:
the float32 phase runs to ``max(tol, 2e-4)`` and a compact Krylov-Schur
solve continues from its Schur rows in float64 (``solvers/refine.py``; no
double-word arithmetic: Hopper has float64).

``checkpoint_path`` writes a snapshot at restart boundaries
(``utils/checkpoint.py``: the head rows of the basis, H and the counters,
the JAX package's ``.npz`` keys) and ``resume=True`` continues from one, on
the device path (scalar and block), the host tier and the float32 phase of
a refined solve; a resumed solve repeats the unbroken one's matvecs,
restarts and T.

``mesh=`` (an :class:`~..parallel.Mesh`) runs the solve SPMD over a row
mesh of ``torch.distributed`` ranks, as the JAX package's ``mesh=`` runs
it over a device mesh (``arnoldi_tpu/solvers/krylov_schur.py:364-403``):
each rank holds its row block of the operator (padded to a multiple of
``size * row_granularity``) and of the basis, the projections and norms are
summed over the ranks, the small dense work is replicated, and no solve
runs on the host tier.  Snapshots are then written per rank
(``utils/checkpoint.py``) and resume on any rank count.
"""

import os

import numpy as np
import torch

from ..device import (check_matmul_precision, is_inexact, numpy_dtype,
                      solver_dtype, work_dtype)
from ..linop import as_operator, cast_operator
from ..ops import dense_tier
from ..ops.ortho import block_cgs2
from ..parallel.mesh import Mesh, local_rows
from ..parallel.sharded import mesh_operator, operator_mesh, start_rows, valid_rows
from ..utils import sorting
from ..utils.checkpoint import (RestartCheckpoint, checkpoint_is_sharded,
                                load_checkpoint, load_checkpoint_sharded,
                                save_checkpoint, save_checkpoint_sharded)
from ..utils.history import History
from ..utils.profiling import phase_clock, solve_span
from ..utils.random import rand_normalized_vector
from . import refine as refinement
from .decomposition import default_invariant_tol
from .workspace import DeviceWorkspace, HostWorkspace, uses_host_tier


def _ordered_schur(H, sort_function, real):
    """``(T, Q, eigenvalues, starts, sizes, in_block)`` of the ordered Schur
    form of H: the real form with its 2x2 blocks (``_schur_blocks``) for a
    real work dtype, else the complex triangular form, whose eigenvalues
    are its diagonal and which has no 2x2 block (JAX's
    ``krylov_schur.py:575-582``)."""
    if real:
        T, Q, eigs = dense_tier.ordered_schur_real(H, sort_function=sort_function)
        return (T, Q, eigs, *_schur_blocks(T))
    T, Q = dense_tier.ordered_schur(H, sort_function=sort_function)
    return T, Q, np.diag(T).copy(), [], [], np.zeros(T.shape[0] + 1, dtype=bool)


def _schur_blocks(T):
    """Block starts and sizes of a real quasi-triangular T, and
    ``in_block``: ``in_block[i]`` when positions i-1 and i hold one 2x2
    block (a cut at i would split a conjugate pair)."""
    starts, sizes = dense_tier.real_schur_blocks(T)
    in_block = np.zeros(T.shape[0] + 1, dtype=bool)
    for s, sz in zip(starts, sizes):
        if sz == 2:
            in_block[s + 1] = True
    return starts, sizes, in_block


def check_mesh(A, mesh):
    """The mesh of a solve: ``mesh``, else that of a sharded ``A``, else
    None; raises ``TypeError`` for a ``mesh`` that is not a
    :class:`~..parallel.Mesh`."""
    if mesh is None:
        return operator_mesh(A)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes an arnoldi_tpu_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    return mesh


def _operator_and_dtype(A, host_tier, device, mesh=None):
    """``(op, n, dtype, n_solve)``: the operator on its device, or for the
    host tier no operator (the workspace holds ``A`` itself), and ``A``'s
    dtype promoted by :func:`~..device.solver_dtype` (an integer ``A`` is
    built or cast in float64).  Under a ``mesh`` the operator is this
    rank's sharded block (:func:`~..parallel.sharded.mesh_operator`), ``n``
    the unpadded and ``n_solve`` the padded row count; else ``n_solve =
    n``."""
    a_dtype = getattr(A, "dtype", None)
    if host_tier:
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"need a square operator, got {A.shape}")
        return None, A.shape[0], solver_dtype(a_dtype), A.shape[0]
    # A floating or complex A keeps its dtype (no copy); an integer one is
    # built in, or cast to, its promoted dtype.
    exact = a_dtype is not None and not is_inexact(a_dtype)
    dtype = solver_dtype(a_dtype) if exact else None
    if mesh is not None:
        op, n, n_solve = mesh_operator(A, mesh, device, dtype)
        return op, n, op.dtype, n_solve
    op = as_operator(A, dtype=dtype, device=device)
    if op.shape[1] != op.shape[0]:
        raise ValueError(f"need a square operator, got {op.shape}")
    return op, op.shape[0], op.dtype, op.shape[0]


def _start_rows(n, b, wdtype, dev, *, v0, generator, start_block, tol,
                mesh=None, n_solve=None):
    """The (b, n) orthonormal start block on ``dev``: ``v0`` (or a unit
    Gaussian vector from ``generator``) and, for b > 1, b - 1 further
    Gaussian rows from ``generator`` (or ``start_block`` in place of both),
    orthonormalized by ``block_cgs2``, which keeps row 0 parallel to v0.

    Under a ``mesh`` every rank draws and normalizes the whole vector from
    the same generator, pads it to ``n_solve`` (the further rows are drawn
    over ``n_solve``, as the JAX package draws them) and keeps its columns:
    the (b, n_local) block, orthonormalized over the mesh."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if start_block is not None and b == 1:
        raise ValueError("_start_block is for the block driver (block_size > 1)")
    if v0 is None:
        v0 = rand_normalized_vector(n, wdtype, device=dev, generator=generator)
    else:
        v0 = torch.as_tensor(v0).to(device=dev, dtype=wdtype)
        v0 = v0 / torch.linalg.vector_norm(v0)
    if mesh is not None:
        if start_block is not None:
            start_block = torch.nn.functional.pad(
                torch.as_tensor(start_block).to(device=dev, dtype=wdtype),
                (0, n_solve - n))
        n = n_solve
        v0 = torch.nn.functional.pad(v0, (0, n_solve - v0.shape[0]))
    if b == 1:
        W0 = v0[None, :]
    elif start_block is None:
        extra = torch.randn((b - 1, n), generator=generator, dtype=wdtype).to(dev)
        W0 = torch.cat([v0[None, :], extra])
    else:
        W0 = torch.as_tensor(start_block).to(device=dev, dtype=wdtype)
        if W0.shape != (b, n):
            raise ValueError(f"_start_block must be ({b}, {n}), got "
                             f"{tuple(W0.shape)}")
    if mesh is not None:
        W0 = start_rows(W0[0, :], W0[1:] if b > 1 else None, n_solve, mesh)
    if b == 1:
        return W0
    # No active rows: block_cgs2 reads none of its first argument.
    return block_cgs2(W0, W0, 0, tol=tol, mesh=mesh)[1]


def _workspace(A, op, device, max_dim, b, ortho, clock, wdtype, mesh=None):
    """The host tier's workspace (in ``wdtype``) for ``op=None``, else the
    device one (this rank's columns under a ``mesh``)."""
    if op is None:
        return HostWorkspace(A, max_dim, ortho, clock, device,
                             dtype=numpy_dtype(wdtype))
    return DeviceWorkspace(op, max_dim, b, ortho, clock, mesh=mesh)


@solve_span(lambda out: out[2].total_matvecs)
def partial_schur(
    A,
    nev,
    *,
    max_dim=None,
    stopping_criterion=None,
    max_restarts=100,
    sort_function=None,
    p=None,
    ortho="cgs_dgks",
    dtype=None,
    generator=None,
    v0=None,
    device=None,
    lock="soft",
    refine="auto",
    block_size=1,
    mesh=None,
    checkpoint_path=None,
    checkpoint_every=1,
    resume=False,
    _start_block=None,
):
    """Compute a partial Schur decomposition ``A Q ~= Q T`` with the
    Krylov-Schur algorithm on ``A``'s device.

    Parameters
    ----------
    A : an operator of this package, a torch tensor, a NumPy array or a
        SciPy sparse matrix (see :func:`arnoldi_tpu_torch.as_operator`).
    nev : number of wanted eigenpairs.
    max_dim : Krylov space dimension m; default ``min(max(2*nev+1, 20), n)``,
        rounded up to a multiple of ``block_size``.
    stopping_criterion : relative-residual tolerance; default
        ``sqrt(eps(A.dtype))``.
    max_restarts : restart budget; raises ``ValueError`` on exhaustion.
    sort_function : "which" selector, a callable or an ARPACK string
        ("LM", "LR", ...); default largest magnitude.
    p : truncation size.  None runs the adaptive retention policy of the
        JAX package (locked prefix plus half the unconverged window,
        rounded up to a quantum of ``max(8, ceil((max_dim - nev) / 3))``
        on a device and of 1 on the host tier);
        an integer pins it.  The block driver has no adaptive policy: its
        default is ``nev + max(5, b)`` rounded up to a multiple of b (at
        most ``max_dim - b``), and p must be a multiple of b.
    ortho : "cgs_dgks" (default), "cgs2", "cgs", "mgs_dgks", "mgs" or
        "cgs2_pallas" (the same function as "cgs2").
    dtype : work dtype, float32, float64, complex64 or complex128; default
        the operator's, made complex by a complex ``v0``.  The operator's
        values are cast to it (the JAX version casts each matvec's result
        instead); a real operator keeps the real Schur path unless it is
        complex.
    generator : CPU ``torch.Generator`` for the start vector and, for the
        block driver, the b - 1 further start rows; default seeded with 0.
    v0 : explicit start vector overriding ``generator`` (the block driver
        still draws its b - 1 further rows from it); used as given (a
        complex one makes the solve complex), then normalized.
    device : where to run; None means the operator's own device (NumPy and
        SciPy input then raise, having none).  SciPy/NumPy input working in
        float64 or complex128 with n <= ``ARNOLDI_HOST_TIER_N`` (default
        32768), or of any size with ``device="cpu"``, runs on the host tier
        whatever ``device`` says (scalar driver, ``ortho`` one of
        "cgs_dgks", "cgs2", "mgs_dgks"; the C++ engine for float64 sparse
        input, built with ``g++`` on first use), and its results are copied
        to ``device`` at the end.
    lock : "soft" (default) or "hard", as in the JAX package; the block
        driver always locks softly.
    refine : "auto" (default), "dw", or None / "none" / False (off).
        "auto" refines a real float32 solve to a tolerance below 1e-6 on a
        format operator, a Gram over format operators or a callable with
        ``fn_f64``: the float32 phase runs to ``max(tol, 2e-4)``, then a
        float64 Krylov-Schur solve in a compact subspace (``m = min(max_dim,
        max(2 nev + 6, 16))``, ``p = min(nev + 5, m - 1)``) continues from
        its Schur rows to ``tol`` on the operator at its own values, and Q
        and T come back in float64.  "dw" refines any solve (never on the
        host tier).  ``History.total`` counts both phases' matvecs, the
        restarts add up, and the residual trace ends with the target tol.
        A complex solve is never refined: "dw" with a complex work dtype
        raises ``ValueError``.
    block_size : ``b > 1`` runs block Krylov-Schur: b vectors a step, two
        block-gemm projections and CholQR2 (``block_cgs2``).  Finds
        eigenvalues of multiplicity up to b, and reads the basis once per b
        matvecs.  Repeated saturation of the block expansion without
        convergence raises ``ValueError``.
    mesh : an :class:`arnoldi_tpu_torch.parallel.Mesh` (``make_mesh``): every
        rank of the mesh calls ``partial_schur`` with the same arguments and
        runs the solve on its row block.  ``A`` is then a format operator or
        SciPy/NumPy matrix (built on ``device``, default the mesh's,
        padded and sharded with an all-gather of x:
        ``parallel.shard_operator``) or a sharded operator of this mesh
        (``parallel.halo_matvec_closure``, the ring halo), whose mesh is
        the default.  Anything else raises ``TypeError``.
    checkpoint_path : optional path of a restart-boundary snapshot
        (``utils/checkpoint.py``), written every ``checkpoint_every``
        restarts (default 1) after the truncate+expand that follows the
        boundary: the head rows ``V[:p+b]`` (one device-to-host copy), H
        and the counters; under a mesh one shard file a rank and rank 0's
        metadata.  A refined solve snapshots its float32 phase.
    resume : if True and ``checkpoint_path`` exists, continue from it (a
        snapshot of either package); restarts count on from the snapshot's,
        so ``max_restarts`` bounds the total.  Without the file the solve
        starts fresh.  The locked prefix is restored under ``lock="hard"``
        with b = 1 only.  A sharded snapshot needs a mesh, of any size.
    _start_block : private, for tests: a (b, n) block replacing v0 and the
        b - 1 drawn rows of the block driver's start block, which is then
        orthonormalized as the drawn one would be.

    Returns
    -------
    schur_vecs : (n, nev) tensor Q on the device; under a mesh this rank's
        rows of it (``parallel.gather_rows`` joins them).
    schur_mat : (nev, nev) tensor T, quasi-upper-triangular, ordered by
        ``sort_function`` (nev+1 when a 2x2 block straddles the cut);
        upper triangular for a complex work dtype.
    history : ``History`` with per-eigenvalue matvec/restart counts, the
        per-restart residual trace and ``phases``.
    """
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    mesh = check_mesh(A, mesh)
    if lock not in ("soft", "hard"):
        raise ValueError(f"lock={lock!r}: expected 'soft' or 'hard'")
    refinement.check_refine(refine)

    host_tier = mesh is None and refine != "dw" and uses_host_tier(
        A, device=device, dtype=dtype, block_size=b, ortho=ortho, v0=v0)
    op, n, op_dtype, n_solve = _operator_and_dtype(A, host_tier, device, mesh)
    tol = (default_invariant_tol(op_dtype) if stopping_criterion is None
           else float(stopping_criterion))
    if sort_function is None:
        sort_function = sorting.arg_largest_magnitude
    else:
        sort_function = sorting.sort_function_for(sort_function)
    if max_restarts <= 0:
        raise ValueError(f"max_restarts must be positive, got {max_restarts}")
    if max_dim is None:
        max_dim = min(max(2 * nev + 1, 20), n)
    if b > 1:
        max_dim = -(-max_dim // b) * b
        if p is None:
            p = min(-(-(nev + max(5, b)) // b) * b, max_dim - b)
        if p % b:
            raise ValueError(f"p={p} must be a multiple of block_size={b}")
    if p is not None and not nev <= p < max_dim:
        raise ValueError(f"need nev <= p < max_dim, got {nev}, {p}, {max_dim}")
    if not 0 < nev < max_dim <= n:
        raise ValueError(f"need 0 < nev < max_dim <= n, got {nev}, {max_dim}, {n}")

    wdtype = work_dtype(op_dtype, dtype, v0)
    real = not wdtype.is_complex
    do_refine = refinement.refines(refine, op, wdtype, tol)
    tol_target = tol
    if do_refine:
        tol = max(tol, refinement.FLOAT32_PHASE_TOL)
    op_src = op           # the continuation's operator, before the cast
    if host_tier:
        dev = torch.device("cpu")     # where the start vector is made
    else:
        check_matmul_precision(wdtype, op.device)
        op = cast_operator(op, wdtype)
        dev = op.device
    np_wdtype = numpy_dtype(wdtype)

    history = History.from_k(nev)
    clock = phase_clock()

    hard_lock = lock == "hard" and b == 1
    # The truncated leading block of H, kept in float64 on the host between
    # restarts (the device copy is in the work dtype and only gains columns).
    H_trunc_hp = None
    prev_pa = 0
    restart0 = start_dim0 = k_lock = total_matvecs = 0
    with clock("workspace_setup"):
        ws = _workspace(A, op, device, max_dim, b, ortho, clock, wdtype, mesh)
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            ck = _load_snapshot(checkpoint_path, max_dim, b, n_solve, mesh)
            ws.set_start(torch.from_numpy(np.asarray(ck.V[:ck.pa + b])))
            ws.set_h(ck.H_hp)
            H_trunc_hp = ck.H_hp[:ck.pa + b, :ck.pa].copy()
            prev_pa = start_dim0 = ck.pa
            # A frozen prefix is a hard-lock concept: a hard-lock snapshot
            # resumed under soft locking lets its pairs rejoin the sort.
            k_lock = ck.k_lock if hard_lock else 0
            history.matvecs[:] = ck.matvecs
            history.restarts[:] = ck.restarts
            history.residual_trace = list(ck.residual_trace)
            total_matvecs, restart0 = ck.total_matvecs, ck.restart
        else:
            ws.set_start(_start_rows(n, b, wdtype, dev, v0=v0,
                                     generator=generator,
                                     start_block=_start_block, tol=tol,
                                     mesh=mesh, n_solve=n_solve))
    m = ws.expand(start_dim0, tol)
    total_matvecs += m - start_dim0

    has_converged = False
    nev_ret = nev
    adaptive = p is None and b == 1
    saturated = 0   # consecutive unconverged saturations (block driver)
    T_out = None
    for restart in range(restart0, max_restarts):
        happy_breakdown = m != max_dim
        if happy_breakdown and m < nev:
            raise ValueError(
                f"Invariant subspace of dimension {m} < nev={nev} found; "
                "start vector lives in a too-small invariant subspace")

        # The host turn of one restart: H to the host, its ordered Schur
        # form, the truncation enqueued; the next expansion is outside it.
        with clock("restart") as turn:
            turn.count = restart
            H_host = ws.h_host()
            if H_trunc_hp is not None:
                H_host[: prev_pa + b, :prev_pa] = H_trunc_hp
            ka = k_lock
            ma = m - ka
            H_active = H_host[ka:m, ka:m]

            # Ordered Schur form of the active window (real: 2x2 blocks for
            # conjugate pairs).
            with clock("rotate"):
                T2a, Qa, eigs_a, b_starts, b_sizes, in_block = _ordered_schur(
                    H_active, sort_function, real)

            # |h_{m+1,m} Qa[last, i]| / |lambda_i|, or for the block driver
            # ||B Qa[:, i]|| / |lambda_i| with B the b coupling rows; a
            # conjugate pair converges as a unit on the norm of its two entries.
            if b > 1:
                residuals = np.linalg.norm(H_host[m:m + b, :m] @ Qa,
                                           axis=0).astype(np.float64)
                for s, sz in zip(b_starts, b_sizes):
                    if sz == 2:
                        residuals[s] = residuals[s + 1] = np.hypot(
                            residuals[s], residuals[s + 1])
            else:
                residuals = np.abs(Qa[ma - 1, :]).astype(np.float64)
                for s, sz in zip(b_starts, b_sizes):
                    if sz == 2:
                        residuals[s] = residuals[s + 1] = np.hypot(
                            Qa[ma - 1, s], Qa[ma - 1, s + 1])
                residuals *= np.abs(H_host[m, m - 1])
            denom = np.abs(eigs_a)
            denom = np.where(denom == 0, 1.0, denom)
            approximate_convergence = residuals / denom

            # Newly converged leading prefix of the active window; a pair's two
            # positions share one residual, so the scan never stops between them.
            nc = 0
            while nc < ma and approximate_convergence[nc] <= tol:
                nc += 1
            if nc != ma and in_block[nc]:
                raise RuntimeError(
                    "prefix scan split a conjugate pair: unequal pair residuals")
            k_new = ka + nc

            for k in range(ka, min(k_new, nev)):
                if history.matvecs[k] == 0:
                    history.matvecs[k] = total_matvecs
                    history.restarts[k] = restart + 1
            rem = nev - ka
            history.residual_trace.append(
                float(np.max(approximate_convergence[:rem])) if rem > 0 else 0.0)

            if k_new >= nev:
                has_converged = True
                for k in range(nev):
                    if history.matvecs[k] == 0:
                        history.matvecs[k] = total_matvecs
                        history.restarts[k] = restart + 1
                # A 2x2 block straddling the nev boundary cannot be cut: return
                # nev+1 pairs (ARPACK's k/k+1 contract for real problems).
                nev_ret = nev + 1 if in_block[nev - ka] else nev
                cr = nev_ret - ka
                Qp_full = np.zeros((m, nev_ret), dtype=H_host.dtype)
                Qp_full[:ka, :ka] = np.eye(ka)
                Qp_full[ka:, ka:] = Qa[:, :cr]
                T_out = np.zeros((nev_ret, nev_ret), dtype=H_host.dtype)
                T_out[:ka, :ka] = H_host[:ka, :ka]
                if ka:
                    T_out[:ka, ka:] = H_host[:ka, ka:m] @ Qa[:, :cr]
                T_out[ka:, ka:] = T2a[:cr, :cr]
                ws.truncate(Qp_full, m, nev_ret)
                if ka:
                    # Locked pairs froze in lock order; re-sort the converged
                    # output globally, as the no-locking path presents it.
                    T_out, Qs = _ordered_schur(T_out, sort_function, real)[:2]
                    ws.rotate_head(Qs, nev_ret)
                break

            # Block driver: a saturated expansion without convergence (rank
            # deficiency, e.g. a multiplicity beyond the reachable space).  The
            # next expansion runs with a zero breakdown tolerance so that the
            # block's rounding noise extends the space (the block analog of
            # ARPACK's random restart); only repeated saturation with a stagnant
            # residual trace is fatal.
            reseed = False
            if b > 1 and happy_breakdown and min(p, m) >= m:
                saturated += 1
                rt = history.residual_trace
                if saturated >= 3 and len(rt) >= 3 and not rt[-1] < 0.5 * rt[-3]:
                    raise ValueError(
                        f"Krylov expansion saturated at dimension {m} without "
                        f"convergence (block rank deficiency); reduce "
                        f"block_size or max_dim, or use the scalar driver")
                reseed = True
            else:
                saturated = 0

            # Truncation size.  Adaptive: keep the locked prefix plus half the
            # unconverged window, at least ARPACK's nev + min(nconv, (m-nev)/2),
            # rounded up to a quantum q.  q decides which Schur vectors are
            # kept, so it stays the JAX package's: 1 on the host tier (which
            # lands on ARPACK's restart counts), a third of the nev..max_dim
            # span on a device (a few static shapes there).
            if adaptive:
                raw = max(k_new + max((m - k_new) // 2, 1),
                          nev + min(k_new, max((m - nev) // 2, 1)))
                q = 1 if ws.host else max(8, -(-(max_dim - nev) // 3))
                pa = min(-(-raw // q) * q, m - 1)
                pa = max(pa, min(k_new + 1, m - 1))     # window never empty
            else:
                pa = min(p, m) if happy_breakdown else p
            ca = pa - ka
            resolved = False
            if b == 1 and in_block[ca]:      # never for a complex work dtype
                # Keep pa fixed by relocating a 1x1 block across the cut.
                try:
                    T2a, Qa = dense_tier.resolve_straddle(T2a, Qa, ca,
                                                          min_keep=max(rem, nc))
                    resolved = True
                except RuntimeError:
                    pass  # no prefix-safe relocation: step the cut instead
                if resolved:
                    b_starts, b_sizes, in_block = _schur_blocks(T2a)
            if in_block[ca] and not resolved:
                # Step the cut by b (1 for the scalar driver), upward first; a
                # block step can land on another pair, so keep stepping.
                floor = max(rem, nc + 1, 1)   # never drop wanted/locked work
                limit = ma if happy_breakdown else ma - 1
                cand = ca
                while cand + b <= limit and in_block[cand + b]:
                    cand += b
                if cand + b <= limit and not in_block[cand + b]:
                    ca = cand + b
                else:
                    cand = ca
                    while cand - b >= floor and in_block[cand - b]:
                        cand -= b
                    if cand - b >= floor and not in_block[cand - b]:
                        ca = cand - b
                    else:
                        raise ValueError(
                            "Cannot truncate without splitting a conjugate "
                            "pair; increase max_dim or p")
                pa = ka + ca

            # Truncated projected matrix.  The rotation is block diagonal --
            # identity on the locked prefix, Qa[:, :ca] on the active window.
            Qp_full = np.zeros((m, pa), dtype=H_host.dtype)
            Qp_full[:ka, :ka] = np.eye(ka)
            Qp_full[ka:, ka:] = Qa[:, :ca]
            H_new = np.zeros_like(H_host)
            H_new[:ka, :ka] = H_host[:ka, :ka]
            if ka:
                H_new[:ka, ka:pa] = H_host[:ka, ka:m] @ Qa[:, :ca]
            H_new[ka:pa, ka:pa] = T2a[:ca, :ca]
            # Coupling row(s): the residual's projections rotated by the active
            # rotation, with the newly converged prefix's entries (below
            # tol*|lambda|) zeroed so those pairs decouple for good.
            H_new[pa:pa + b, ka:pa] = H_host[m:m + b, ka:m] @ Qa[:, :ca]
            H_new[pa:pa + b, :k_new] = 0.0
            H_trunc_hp = H_new[: pa + b, :pa].copy()
            prev_pa = pa
            if hard_lock:
                k_lock = k_new
            ws.restart(Qp_full, H_new, m, pa)
        m_new = ws.expand(pa, 0.0 if reseed else tol)
        if checkpoint_path and (restart + 1) % max(checkpoint_every, 1) == 0:
            # The expansion only appended rows past pa + b: the head rows of
            # the expanded workspace are the restart-boundary state.
            with clock("checkpoint"):
                ck = RestartCheckpoint(
                    V=ws.V[:pa + b], H_hp=H_new, pa=pa, restart=restart + 1,
                    total_matvecs=total_matvecs,
                    matvecs=history.matvecs.copy(),
                    restarts=history.restarts.copy(),
                    residual_trace=list(history.residual_trace),
                    k_lock=k_lock)
                if mesh is None:
                    save_checkpoint(checkpoint_path, ck)
                else:
                    save_checkpoint_sharded(checkpoint_path, ck, mesh)
        total_matvecs += m_new - pa
        m = m_new

    history.total = total_matvecs
    if not has_converged:
        raise ValueError("Has not converged !")
    if do_refine and tol_target < tol:
        with clock("refine.start_vector"):
            v0r = refinement.refinement_start_vector(ws.V, nev_ret, mesh)
        del ws, op     # free the work-dtype basis before float64 allocates
        Q, T, r_extra, mv_extra = refinement.continue_refined(
            op_src, v0r, nev, max_dim=max_dim, tol=tol_target,
            sort_function=sort_function, max_restarts=max_restarts,
            clock=clock, mesh=mesh)
        history.total = total_matvecs + mv_extra
        history.matvecs[:] = history.total
        history.restarts[:] = history.restarts + r_extra
        history.residual_trace.append(float(tol_target))
        history.phases = clock.report()
        if mesh is not None:
            Q = valid_rows(Q, n, n_solve, mesh)
        return Q, T, history
    history.phases = clock.report()
    schur_vecs = ws.rows(nev_ret)     # back to the (n, nev) contract
    if mesh is not None:
        schur_vecs = valid_rows(schur_vecs, n, n_solve, mesh)
    schur_mat = torch.from_numpy(T_out.astype(np_wdtype)).to(schur_vecs.device)
    return schur_vecs, schur_mat, history


def _load_snapshot(path, max_dim, b, n, mesh=None):
    """A snapshot that fits this solve's workspace (the JAX package's
    checks and messages), ``n`` the (padded) row count; under a ``mesh``
    with ``V`` this rank's columns.  A sharded snapshot needs a mesh."""
    ck = load_checkpoint(path)
    sharded = checkpoint_is_sharded(path)
    if sharded or ck.V is None:       # a mesh snapshot's metadata (no V)
        if mesh is None:
            raise AssertionError(
                "sharded checkpoint: pass a mesh (resume is mesh-elastic — "
                "any device count whose padding covers n)")
        ck = load_checkpoint_sharded(path, mesh, n_solve=n)
    if ck.H_hp.shape != (max_dim + b, max_dim):
        raise AssertionError(
            f"checkpoint H shape {ck.H_hp.shape} does not match workspace "
            f"{(max_dim + b, max_dim)}")
    # Older snapshots (or a full-workspace writer) hold all max_dim + b
    # rows: the head rows are sliced out.
    n_cols = n // mesh.size if sharded else n
    if not (ck.V.shape[0] >= ck.pa + b and ck.V.shape[1] == n_cols):
        raise AssertionError(
            f"checkpoint V shape {ck.V.shape} incompatible with head rows "
            f"{(ck.pa + b, n_cols)}")
    if mesh is not None and not sharded:
        row0, row1 = local_rows(n, mesh)
        ck.V = ck.V[:, row0:row1]
    return ck


def eigenpairs_from_partial_schur(schur_vecs, schur_mat):
    """Eigenpairs from a partial Schur decomposition.

    Returns ``(values, vectors)``: ``values`` a NumPy array, ``vectors`` a
    tensor on ``schur_vecs``' device with unit-norm columns (complex when
    the eigenvalues are).
    """
    T = schur_mat.cpu().numpy() if torch.is_tensor(schur_mat) \
        else np.asarray(schur_mat)
    if np.iscomplexobj(T) and np.allclose(T, np.triu(T)):
        values, S = dense_tier.eig_from_schur(T)
    else:
        values, S = dense_tier.eig(T)
    Q = torch.as_tensor(schur_vecs)
    if np.iscomplexobj(S) and not Q.is_complex():
        # Real basis, complex eigenvectors of T: two real matmuls.
        vr = Q @ torch.from_numpy(np.ascontiguousarray(S.real)).to(Q)
        vi = Q @ torch.from_numpy(np.ascontiguousarray(S.imag)).to(Q)
        vectors = torch.complex(vr, vi)
    else:
        vectors = Q @ torch.from_numpy(np.ascontiguousarray(S)).to(Q)
    norms = torch.linalg.vector_norm(vectors, dim=0)
    return values, vectors / torch.where(norms == 0, 1.0, norms)[None, :]
