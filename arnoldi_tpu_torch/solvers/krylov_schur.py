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
as the TPU path and the host tier do.

Small SciPy/NumPy float64 problems (n <= 32768, or any n when the target
device is the CPU) run the whole solve on the host tier instead
(``workspace.HostWorkspace``, :func:`~.workspace.uses_host_tier`), as the
JAX package does, and return their results on the requested device.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): complex dtypes, ``mesh``, checkpointing and double-word refinement.
"""

import numpy as np
import torch

from ..device import (check_matmul_precision, is_inexact, numpy_dtype,
                      solver_dtype, torch_dtype)
from ..linop import as_operator, cast_operator
from ..ops import dense_tier
from ..ops.ortho import block_cgs2
from ..utils import sorting
from ..utils.history import History
from ..utils.profiling import phase_clock
from ..utils.random import rand_normalized_vector
from .decomposition import default_invariant_tol
from .workspace import DeviceWorkspace, HostWorkspace, uses_host_tier


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to arnoldi_tpu_torch yet (ROADMAP.md, {item})")


def _work_dtype(op_dtype, dtype):
    wdtype = op_dtype if dtype is None else torch_dtype(dtype)
    if wdtype.is_complex:
        raise _not_ported("a complex work dtype", "Queue 1 item 5")
    if wdtype not in (torch.float32, torch.float64):
        raise TypeError(f"work dtype must be float32 or float64, got {wdtype}")
    return wdtype


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


def _operator_and_dtype(A, host_tier, device):
    """``(op, n, dtype)``: the operator on its device, or for the host tier
    no operator (the workspace holds ``A`` itself), and ``A``'s dtype
    promoted by :func:`~..device.solver_dtype` (an integer ``A`` is built
    or cast in float64)."""
    a_dtype = getattr(A, "dtype", None)
    if host_tier:
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"need a square operator, got {A.shape}")
        return None, A.shape[0], solver_dtype(a_dtype)
    # A floating or complex A keeps its dtype (no copy); an integer one is
    # built in, or cast to, its promoted dtype.
    exact = a_dtype is not None and not is_inexact(a_dtype)
    op = as_operator(A, dtype=solver_dtype(a_dtype) if exact else None,
                     device=device)
    if op.shape[1] != op.shape[0]:
        raise ValueError(f"need a square operator, got {op.shape}")
    return op, op.shape[0], op.dtype


def _check_refine(refine, wdtype, tol):
    if refine == "dw" or (refine == "auto" and wdtype == torch.float32
                          and tol < 1e-6):
        raise _not_ported("refine (a float32 solve below tol 1e-6 continued "
                          "in higher precision)", "Queue 1 item 8")
    if refine not in ("auto", None, "none", False):
        raise ValueError(f"refine={refine!r}: expected 'auto', 'dw' or None")


def _start_rows(n, b, wdtype, dev, *, v0, generator, start_block, tol):
    """The (b, n) orthonormal start block on ``dev``: ``v0`` (or a unit
    Gaussian vector from ``generator``) and, for b > 1, b - 1 further
    Gaussian rows from ``generator`` (or ``start_block`` in place of both),
    orthonormalized by ``block_cgs2``, which keeps row 0 parallel to v0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if start_block is not None and b == 1:
        raise ValueError("_start_block is for the block driver (block_size > 1)")
    if v0 is None:
        v0 = rand_normalized_vector(n, wdtype, device=dev, generator=generator)
    else:
        if v0.is_complex() if torch.is_tensor(v0) else np.iscomplexobj(v0):
            raise _not_ported("a complex start vector", "Queue 1 item 5")
        v0 = torch.as_tensor(v0).to(device=dev, dtype=wdtype)
        v0 = v0 / torch.linalg.vector_norm(v0)
    if b == 1:
        return v0[None, :]
    if start_block is None:
        extra = torch.randn((b - 1, n), generator=generator, dtype=wdtype).to(dev)
        W0 = torch.cat([v0[None, :], extra])
    else:
        W0 = torch.as_tensor(start_block).to(device=dev, dtype=wdtype)
        if W0.shape != (b, n):
            raise ValueError(f"_start_block must be ({b}, {n}), got "
                             f"{tuple(W0.shape)}")
    # No active rows: block_cgs2 reads none of its first argument.
    return block_cgs2(W0, W0, 0, tol=tol)[1]


def _workspace(A, op, device, max_dim, b, ortho, clock):
    """The host tier's workspace for ``op=None``, else the device one."""
    if op is None:
        return HostWorkspace(A, max_dim, ortho, clock, device)
    return DeviceWorkspace(op, max_dim, b, ortho, clock)


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
    dtype : work dtype, float32 or float64; default the operator's.  The
        operator's values are cast to it (the JAX version casts each
        matvec's result instead).
    generator : CPU ``torch.Generator`` for the start vector and, for the
        block driver, the b - 1 further start rows; default seeded with 0.
    v0 : explicit start vector overriding ``generator`` (the block driver
        still draws its b - 1 further rows from it).
    device : where to run; None means the operator's own device (NumPy and
        SciPy input then raise, having none).  SciPy/NumPy float64 input
        with n <= ``ARNOLDI_HOST_TIER_N`` (default 32768), or of any size
        with ``device="cpu"``, runs on the host tier whatever ``device``
        says (scalar driver, ``ortho`` one of "cgs_dgks", "cgs2",
        "mgs_dgks"; the C++ engine for sparse input, built with ``g++`` on
        first use), and its results are copied to ``device`` at the end.
    lock : "soft" (default) or "hard", as in the JAX package; the block
        driver always locks softly.
    refine : "auto" (default) or None.  A float32 solve to a tolerance
        below 1e-6, where the JAX package would continue in double-word
        arithmetic, raises ``NotImplementedError``; so does "dw".
    block_size : ``b > 1`` runs block Krylov-Schur: b vectors a step, two
        block-gemm projections and CholQR2 (``block_cgs2``).  Finds
        eigenvalues of multiplicity up to b, and reads the basis once per b
        matvecs.  Repeated saturation of the block expansion without
        convergence raises ``ValueError``.
    mesh, checkpoint_path, resume : accepted for signature parity; anything
        but their defaults raises ``NotImplementedError``.
    _start_block : private, for tests: a (b, n) block replacing v0 and the
        b - 1 drawn rows of the block driver's start block, which is then
        orthonormalized as the drawn one would be.

    Returns
    -------
    schur_vecs : (n, nev) tensor Q on the device.
    schur_mat : (nev, nev) tensor T, quasi-upper-triangular, ordered by
        ``sort_function`` (nev+1 when a 2x2 block straddles the cut).
    history : ``History`` with per-eigenvalue matvec/restart counts, the
        per-restart residual trace and ``phases``.
    """
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    if mesh is not None:
        raise _not_ported("mesh= (sharded solves)", "Queue 1 item 13")
    if checkpoint_path is not None or resume:
        raise _not_ported("checkpoint_path=/resume=", "Queue 1 item 14")
    if lock not in ("soft", "hard"):
        raise ValueError(f"lock={lock!r}: expected 'soft' or 'hard'")

    host_tier = uses_host_tier(A, device=device, dtype=dtype, block_size=b,
                               ortho=ortho)
    op, n, op_dtype = _operator_and_dtype(A, host_tier, device)
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

    wdtype = _work_dtype(op_dtype, dtype)
    _check_refine(refine, wdtype, tol)
    if host_tier:
        dev = torch.device("cpu")     # where the start vector is made
    else:
        check_matmul_precision(wdtype, op.device)
        op = cast_operator(op, wdtype)
        dev = op.device
    np_wdtype = numpy_dtype(wdtype)

    history = History.from_k(nev)
    clock = phase_clock()

    with clock("workspace_setup"):
        ws = _workspace(A, op, device, max_dim, b, ortho, clock)
        ws.set_start(_start_rows(n, b, wdtype, dev, v0=v0, generator=generator,
                                 start_block=_start_block, tol=tol))
    m = ws.expand(0, tol)
    total_matvecs = m

    has_converged = False
    nev_ret = nev
    hard_lock = lock == "hard" and b == 1
    k_lock = 0
    adaptive = p is None and b == 1
    saturated = 0   # consecutive unconverged saturations (block driver)
    # The truncated leading block of H, kept in float64 on the host between
    # restarts (the device copy is in the work dtype and only gains columns).
    H_trunc_hp = None
    prev_pa = 0
    T_out = None
    for restart in range(max_restarts):
        happy_breakdown = m != max_dim
        if happy_breakdown and m < nev:
            raise ValueError(
                f"Invariant subspace of dimension {m} < nev={nev} found; "
                "start vector lives in a too-small invariant subspace")

        H_host = ws.h_host()
        if H_trunc_hp is not None:
            H_host[: prev_pa + b, :prev_pa] = H_trunc_hp
        ka = k_lock
        ma = m - ka
        H_active = H_host[ka:m, ka:m]

        # Ordered real Schur form of the active window (2x2 blocks for
        # conjugate pairs).
        with clock("rotate"):
            T2a, Qa, eigs_a = dense_tier.ordered_schur_real(
                H_active, sort_function=sort_function)
        b_starts, b_sizes, in_block = _schur_blocks(T2a)

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
            Qp_full = np.zeros((m, nev_ret))
            Qp_full[:ka, :ka] = np.eye(ka)
            Qp_full[ka:, ka:] = Qa[:, :cr]
            T_out = np.zeros((nev_ret, nev_ret))
            T_out[:ka, :ka] = H_host[:ka, :ka]
            if ka:
                T_out[:ka, ka:] = H_host[:ka, ka:m] @ Qa[:, :cr]
            T_out[ka:, ka:] = T2a[:cr, :cr]
            ws.truncate(Qp_full, m, nev_ret)
            if ka:
                # Locked pairs froze in lock order; re-sort the converged
                # output globally, as the no-locking path presents it.
                T_out, Qs, _ = dense_tier.ordered_schur_real(
                    T_out, sort_function=sort_function)
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
        if b == 1 and in_block[ca]:
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
        Qp_full = np.zeros((m, pa))
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

        m_new = ws.restart(Qp_full, H_new, m, pa, 0.0 if reseed else tol)
        total_matvecs += m_new - pa
        m = m_new

    history.total = total_matvecs
    if not has_converged:
        raise ValueError("Has not converged !")
    history.phases = clock.report()
    schur_vecs = ws.rows(nev_ret)     # back to the (n, nev) contract
    schur_mat = torch.from_numpy(T_out.astype(np_wdtype)).to(schur_vecs.device)
    return schur_vecs, schur_mat, history


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
