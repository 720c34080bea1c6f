"""Hermitian driver: thick-restart Lanczos (``partial_eigh``).

Counterpart of ``arnoldi_tpu/solvers/lanczos.py``.  Krylov-Schur
specialized to a Hermitian projected matrix (Wu & Simon's thick restart),
real symmetric or complex Hermitian by the work dtype (the rule of
``partial_schur``: a complex operator, ``dtype=`` or ``v0`` makes it
complex; the Ritz values are real either way):
the Rayleigh-Ritz step is a small ``eigh``, and after a restart the
projected matrix is arrowhead (the kept Ritz values on the diagonal and the
residual block's coupling row), which the next ``eigh`` treats uniformly.

Two restart loops, chosen as the JAX package chooses them:

* the device loop (:func:`_trl_device_loop`, the counterpart of
  ``_trl_solve_jit``): the ``eigh``, wanted-first order, residuals,
  truncation and rebuild of H stay on the operator's device in the work
  dtype, and the host reads only the convergence and health flags once per
  restart.  It is the default unless the solve runs on the host tier, uses
  the selective kernel or passes a callable ``ortho``.  A breakdown in it
  (an invariant subspace, or a rank-deficient block) falls back to
* the host-orchestrated loop: the ``eigh`` in float64 on the host, with
  the truncated block of H kept in float64 between restarts.  It runs on
  the device workspace, or on the host tier (``workspace.HostWorkspace``).

``torch.linalg.eigh`` on a CUDA tensor is cuSOLVER's (the JAX loop uses
XLA's, not a Pallas kernel); it loads its library on its first call.

A float32 solve below tol 1e-6 is refined as ``partial_schur`` refines it
(``solvers/refine.py``): the float32 phase to ``max(tol, 2e-4)``, then a
float64 Krylov-Schur continuation from its Ritz rows, whose Schur form gives
the values (its diagonal) and the vectors.
"""

from functools import partial

import numpy as np
import torch

from ..utils.history import History
from ..device import check_matmul_precision, work_dtype
from ..linop import cast_operator
from ..ops.ortho import M_SQRT1_2, cgs_dgks, vector_norm
from ..parallel.sharded import valid_rows
from ..utils.profiling import phase_clock, solve_span
from . import refine as refinement
from .decomposition import default_invariant_tol
from .krylov_schur import (_operator_and_dtype, _start_rows, _workspace,
                           check_mesh)
from .workspace import DeviceWorkspace, uses_host_tier

__all__ = ["partial_eigh", "lanczos_selective_ortho",
           "make_lanczos_selective_ortho", "SYM_SORTS"]


def _selective_ortho(Vt, w, n_active, *, n_locked, tol=1e-8, eta=M_SQRT1_2,
                     mesh=None):
    """One pass against rows ``[0, min(n_locked, n_active))`` and the last
    two active rows ``[n_active - 2, n_active)``, each row once where the
    two ranges overlap (the JAX kernel's mask is their union), then a full
    :func:`cgs_dgks` pass when ``beta1 < eta * ||w||``.  The pass is two
    ``torch.matmul`` pairs over contiguous row slices, as the JAX kernel's
    is a masked ``jnp.matmul``.  Under a ``mesh`` the coefficients and
    norms are summed over the ranks."""
    n_active = int(n_active)
    lo = min(n_locked, n_active)
    hi = max(n_active - 2, lo)
    beta_before = vector_norm(w, mesh)
    h = torch.zeros(Vt.shape[0], dtype=Vt.dtype, device=Vt.device)
    h[:lo] = Vt[:lo].conj() @ w
    h[hi:n_active] = Vt[hi:n_active].conj() @ w
    if mesh is not None:
        h = mesh.all_reduce(h)
    w = w - h[:lo] @ Vt[:lo] - h[hi:n_active] @ Vt[hi:n_active]
    beta = vector_norm(w, mesh)
    if bool(beta < eta * beta_before):
        h2, w, beta, _ = cgs_dgks(Vt, w, n_active, tol=tol, eta=eta, mesh=mesh)
        h = h + h2
    return h, w, beta, beta < tol


def make_lanczos_selective_ortho(n_locked):
    """The selective-orthogonalization kernel for thick-restart Lanczos:
    against the ``n_locked`` leading (compressed Ritz) rows and the two
    3-term recurrence partners, with a DGKS-triggered full fallback.
    Contract ``(h, w, beta, breakdown)``, as every ortho kernel."""
    return partial(_selective_ortho, n_locked=int(n_locked))


#: The selective kernel with no locked block.
lanczos_selective_ortho = make_lanczos_selective_ortho(0)


def _device_order(which, theta, m):
    """Wanted-first order of ``eigh``'s ascending eigenvalues, on their
    device; a stable sort, so ties order as in JAX."""
    if which == "LA":
        return torch.arange(m - 1, -1, -1, device=theta.device)
    if which == "SA":
        return torch.arange(m, device=theta.device)
    if which == "LM":
        return torch.argsort(-theta.abs(), stable=True)
    if which == "SM":
        return torch.argsort(theta.abs(), stable=True)
    raise ValueError(which)


def _trl_device_loop(op, V0, tol, *, nev, p, max_dim, max_restarts, which,
                     ortho, clock, mesh=None):
    """Thick-restart Lanczos with the whole restart loop on ``op``'s device.

    Returns ``(ws, theta, converged, healthy, restarts, trace)``: after a
    convergence the workspace holds the truncated basis, whose first rows
    are the Ritz vectors of ``theta``.  ``healthy`` is False after any
    breakdown in an expansion, which the fixed bookkeeping of this loop
    does not handle.  The expansions read no breakdown flag per step: the
    host reads the health flag once per expansion and the convergence flag
    once per restart (``cgs_dgks`` still reads its DGKS test each step).
    """
    b = V0.shape[0]
    m = max_dim
    ws = DeviceWorkspace(op, max_dim, b, ortho, clock, mesh=mesh)
    ws.set_start(V0)

    def expand(start):
        return not bool(ws.expand(start, tol, stop_at_breakdown=False))

    healthy = expand(0)
    conv, r, theta, trace = False, 0, None, []
    while not conv and healthy and r < max_restarts:
        with clock("restart") as turn:
            turn.count = r
            H = ws.H
            Ha = H[:m, :m]
            theta, S = torch.linalg.eigh((Ha + Ha.mH) * 0.5)  # ascending, real
            order = _device_order(which, theta, m)
            theta, S = theta[order], S[:, order]
            coupling = H[m:m + b, :m]
            res = torch.linalg.vector_norm(coupling @ S, dim=0)
            rel = res / torch.clamp(theta.abs(), min=1e-30)
            trace.append(rel[:nev].max())
            Sp = S[:, :p].contiguous()
            ws.truncate(Sp, m, p)
            H2 = torch.zeros_like(H)
            H2.diagonal()[:p] = theta[:p]
            H2[p:p + b, :p] = coupling @ Sp
            ws.set_h(H2)
            conv = bool((rel[:nev] < tol).all())    # the one read per restart
        if not conv:
            healthy = expand(p)
        r += 1
    trace = torch.stack(trace).cpu().tolist() if trace else []
    return ws, theta, conv, healthy, r, trace


def _sym_sort(which):
    which = which.upper()
    if which == "LA":
        return lambda x: np.argsort(-np.real(x), kind="stable")
    if which == "SA":
        return lambda x: np.argsort(np.real(x), kind="stable")
    if which == "LM":
        return lambda x: np.argsort(-np.abs(x), kind="stable")
    if which == "SM":
        return lambda x: np.argsort(np.abs(x), kind="stable")
    raise ValueError(f"which={which!r}: expected LA, SA, LM or SM")


SYM_SORTS = ("LA", "SA", "LM", "SM")


@solve_span(lambda out: out[2].total_matvecs)
def partial_eigh(
    A,
    nev,
    *,
    which="LA",
    max_dim=None,
    stopping_criterion=None,
    max_restarts=1000,
    ortho="cgs_dgks",
    dtype=None,
    generator=None,
    v0=None,
    device=None,
    mesh=None,
    block_size=1,
    device_loop=None,
    refine="auto",
    _start_block=None,
):
    """Compute ``nev`` extremal eigenpairs of a symmetric or Hermitian
    operator by thick-restart Lanczos.

    Parameters are :func:`~arnoldi_tpu_torch.partial_schur`'s (``A``,
    ``max_dim``, ``stopping_criterion``, ``max_restarts``, ``dtype``,
    ``generator``, ``v0``, ``device``, ``refine``, ``_start_block``; the
    host tier routes SciPy/NumPy input the same way; a refined solve returns
    float64 values and vectors), and:

    which : "LA", "SA", "LM" or "SM".
    ortho : an ortho kernel name or callable; "selective" projects against
        the locked Ritz rows and the 3-term partners, with a DGKS-triggered
        full pass (:func:`make_lanczos_selective_ortho`).
    block_size : ``b > 1`` runs block thick-restart Lanczos (b vectors a
        step, ``block_cgs2``): ``max_dim`` rounds up to a multiple of b and
        ``p = min(ceil((nev + max(5, b)) / b) * b, max_dim - b)``.  Finds
        eigenvalues of multiplicity up to b.
    device_loop : run the whole restart loop on the device (default: yes,
        unless the solve is on the host tier, uses the selective kernel or
        a callable ``ortho``); a breakdown there falls back to the
        host-orchestrated loop from the same start block.
    mesh : a row mesh (:func:`~arnoldi_tpu_torch.partial_schur`'s
        ``mesh``): the host-orchestrated loop runs on every rank over its
        row block, as the JAX package runs it under a mesh (the device loop
        only when ``device_loop=True``), and the eigenvectors come back as
        this rank's rows.

    Returns ``(eigenvalues, eigenvectors, history)``: the eigenvalues as a
    real NumPy array, wanted-first (descending for "LA"), and the
    eigenvectors as an (n, nev) tensor on the device in the work dtype (the
    Ritz basis rows).
    """
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    mesh = check_mesh(A, mesh)
    sort_function = _sym_sort(which)
    if max_restarts <= 0:
        raise ValueError(f"max_restarts must be positive, got {max_restarts}")
    refinement.check_refine(refine)

    host_tier = (mesh is None and device_loop is not True and refine != "dw"
                 and uses_host_tier(A, device=device, dtype=dtype,
                                    block_size=b, ortho=ortho, v0=v0))
    op, n, op_dtype, n_solve = _operator_and_dtype(A, host_tier, device, mesh)
    tol = (default_invariant_tol(op_dtype) if stopping_criterion is None
           else float(stopping_criterion))
    if max_dim is None:
        max_dim = min(max(2 * nev + 1, 20), n)
    if b > 1:
        max_dim = -(-max_dim // b) * b
        p = min(-(-(nev + max(5, b)) // b) * b, max_dim - b)
    else:
        p = min(nev + 5, max_dim - 1)
    if not (0 < nev <= p < max_dim <= n):
        raise ValueError(f"need 0 < nev <= p < max_dim <= n, got nev={nev}, "
                         f"p={p}, max_dim={max_dim}, b={b}, n={n}; change "
                         "max_dim")

    wdtype = work_dtype(op_dtype, dtype, v0)
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

    selective = ortho == "selective"
    ortho_fn = lanczos_selective_ortho if selective else ortho
    use_device_loop = (
        device_loop if device_loop is not None
        else (mesh is None and not selective and which in SYM_SORTS
              and isinstance(ortho, str) and not host_tier))

    history = History.from_k(nev)
    clock = phase_clock()

    def refined(v0r):
        """Continue the converged phase in float64 from ``v0r`` (JAX's
        ``_refine_result``): values ``diag(T)[:nev]``, vectors ``Q[:, :nev]``."""
        Q, T, r_extra, mv_extra = refinement.continue_refined(
            op_src, v0r, nev, max_dim=max_dim, tol=tol_target,
            sort_function=sort_function, max_restarts=max_restarts,
            clock=clock, mesh=mesh)
        history.total = history.total_matvecs + mv_extra
        history.matvecs[:] = history.total
        history.restarts[:] = history.restarts + r_extra
        history.phases = clock.report()
        if mesh is not None:
            Q = valid_rows(Q, n, n_solve, mesh)
        return torch.diagonal(T)[:nev].cpu().numpy(), Q[:, :nev], history

    # The start block stays apart from the workspaces, so the fallback
    # after a device-loop breakdown starts from it again.
    with clock("workspace_setup"):
        V0 = _start_rows(n, b, wdtype, dev, v0=v0, generator=generator,
                         start_block=_start_block, tol=tol, mesh=mesh,
                         n_solve=n_solve)

    if use_device_loop:
        loop_ortho = ortho if isinstance(ortho, str) and not selective \
            else "cgs_dgks"
        with clock("trl.device_loop"):
            ws, theta, conv, healthy, r, trace = _trl_device_loop(
                op, V0, tol, nev=nev, p=p, max_dim=max_dim,
                max_restarts=max_restarts, which=which.upper(),
                ortho=loop_ortho, clock=clock, mesh=mesh)
        if healthy:
            history.residual_trace = trace
            history.restarts[:] = r
            total = max_dim + max(r - 1, 0) * (max_dim - p)
            history.matvecs[:] = total
            history.total = total
            if not conv:
                raise ValueError("Has not converged !")
            if do_refine and tol_target < tol:
                with clock("refine.start_vector"):
                    v0r = refinement.refinement_start_vector(ws.V, nev, mesh)
                del ws, op    # free the work-dtype basis before float64 allocates
                return refined(v0r)
            history.phases = clock.report()
            vectors = ws.rows(nev)
            if mesh is not None:
                vectors = valid_rows(vectors, n, n_solve, mesh)
            return theta[:nev].cpu().numpy(), vectors, history
        del ws   # breakdown: the host-orchestrated loop from V0, counts from 0

    ws = _workspace(A, op, device, max_dim, b, ortho_fn, clock, wdtype, mesh)
    ws.set_start(V0)
    m = ws.expand(0, tol)
    total_matvecs = m

    H_trunc_hp = None
    prev_pa = 0
    theta_final = None
    has_converged = False
    for restart in range(max_restarts):
        happy_breakdown = m != max_dim
        if happy_breakdown and m < nev:
            raise ValueError(
                f"Invariant subspace of dimension {m} < nev={nev} found")

        with clock("restart") as turn:
            turn.count = restart
            H_host = ws.h_host()
            if H_trunc_hp is not None:
                H_host[: prev_pa + b, :prev_pa] = H_trunc_hp
            H_active = H_host[:m, :m]

            # Rayleigh-Ritz on the Hermitian part of the projected matrix (it
            # scrubs float32 rounding).
            theta, S = np.linalg.eigh((H_active + H_active.conj().T) / 2)
            order = np.asarray(sort_function(theta))
            theta, S = theta[order], S[:, order]

            pa = min(p, m) if happy_breakdown else p
            if b > 1:
                pa = min(-(-pa // b) * b, m)
            Sp = S[:, :pa]
            ws.truncate(Sp, m, pa)

            H_new = np.zeros_like(H_host)
            H_new[np.arange(pa), np.arange(pa)] = theta[:pa]
            # The coupling block: the residual block's projections rotated by
            # Sp (for b = 1 the arrowhead row).
            H_new[pa:pa + b, :pa] = H_host[m:m + b, :m] @ Sp
            H_trunc_hp = H_new[: pa + b, :pa].copy()
            prev_pa = pa

            # Residual estimates ||B S[:, i]|| / |theta_i|, B the coupling rows.
            residuals = np.linalg.norm(H_host[m:m + b, :m] @ S, axis=0)
            denom = np.abs(theta)
            approximate_convergence = residuals / np.where(denom == 0, 1.0, denom)

            for k in range(nev):
                if approximate_convergence[k] <= tol:
                    history.matvecs[k] = total_matvecs
                    history.restarts[k] = restart + 1
            history.residual_trace.append(
                float(np.max(approximate_convergence[:nev])))

            has_converged = bool(np.all(approximate_convergence[:nev] < tol))
            if has_converged and happy_breakdown:
                history.matvecs[:] = np.maximum(history.matvecs, total_matvecs)
                history.restarts[:] = np.maximum(history.restarts, restart + 1)
            if not has_converged and happy_breakdown and pa >= m:
                raise ValueError(
                    f"Krylov expansion saturated at dimension {m} without "
                    f"convergence (block rank deficiency); reduce block_size or "
                    f"max_dim, or use the scalar driver")
            if has_converged:
                theta_final = theta
                break

            ws.set_h(H_new)
            if selective:
                # After a thick restart the leading pa + 1 rows are the
                # compressed Ritz block; new vectors stay orthogonal to it.
                ws.ortho = make_lanczos_selective_ortho(pa + 1)
        m_new = ws.expand(pa, tol)
        total_matvecs += m_new - pa
        m = m_new

    history.total = total_matvecs
    if not has_converged:
        raise ValueError("Has not converged !")
    if do_refine and tol_target < tol:
        with clock("refine.start_vector"):
            v0r = refinement.refinement_start_vector(ws.V, nev, mesh)
        del ws, op    # free the work-dtype basis before float64 allocates
        return refined(v0r)
    history.phases = clock.report()
    vectors = ws.rows(nev)
    if mesh is not None:
        vectors = valid_rows(vectors, n, n_solve, mesh)
    return np.real(theta_final[:nev]), vectors, history
