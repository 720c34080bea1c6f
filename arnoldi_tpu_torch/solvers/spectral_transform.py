"""Spectral transformations and the SciPy-compatible ``eigs``/``eigsh``.

Counterpart of ``arnoldi_tpu/solvers/spectral_transform.py``.  The matvec
of ``(A - sigma I)^{-1}`` is an inner Krylov solve (``solvers/inner.py``:
cg, bicgstab or restarted gmres, the recurrences of
``jax.scipy.sparse.linalg``) over the operator's own kernels, wrapped as a
:class:`~arnoldi_tpu_torch.linop.CallableOperator` on the operator's
device that the outer ``partial_schur``/``partial_eigh`` consumes
unchanged; eigenvalues transform back as ``lambda = sigma + 1/theta``.
``solver="splu"`` factorizes the host matrix once with SciPy's sparse LU
instead, and every application copies ``b`` to the host and ``x`` back:
the one path of this module that works on the host, and only when asked.

A complex shift of a real operator makes the shifted product complex, as
the JAX package's CPU backend makes every solve complex: the transformed
operator is complex, so the outer solve is, and the real operator is
applied to the real and imaginary parts of each vector as two columns of
its b-column kernel (never cast: the real values are read once for both
parts, at half a complex operator's bytes).

The API is the JAX package's with the port's conventions: ``generator=``
(a CPU ``torch.Generator``) replaces ``key=``, ``device=`` places SciPy and
NumPy input, eigenvalues come back as NumPy arrays and eigenvectors as
tensors on the operator's device.  ``count_inner=True`` attaches an
:class:`InnerSolveStats` counted with plain integers (the solvers report
their products); inside :func:`accounting`, every transformed operator
counts and every outer solve's ``History`` is kept, the drivers returning
neither.  The realified route (``realify_operator``,
``eigs_realified``) is ported for parity: ``eigs`` never takes it, the
card having complex types (the JAX package takes it on the TPU only).
"""

import contextlib

import numpy as np
import torch

from ..device import is_inexact, numpy_dtype, solver_dtype, torch_dtype
from ..linop import CallableOperator, _require_device, as_operator
from ..utils.profiling import phase_clock, solve_span
from ..utils.sorting import sort_function_for
from . import inner
from .decomposition import default_invariant_tol
from .krylov_schur import eigenpairs_from_partial_schur, partial_schur
from .lanczos import SYM_SORTS, partial_eigh

__all__ = ["accounting", "shift_invert_operator", "generalized_operator",
           "realify_operator", "eigs", "eigs_realified", "eigsh"]

_SOLVERS = {"bicgstab": inner.bicgstab, "cg": inner.cg, "gmres": inner.gmres}
#: GMRES's restart window on the shifted systems: restarted GMRES stagnates
#: on indefinite systems with the default window of 20 (JAX's value).
GMRES_RESTART = 80


class InnerSolveStats:
    """Inner-solve accounting of a shift-invert or generalized operator:
    ``solves`` (applications) and ``inner_matvecs`` (products with the
    shifted operator, the initial residual's included)."""

    def __init__(self):
        self.solves = 0
        self.inner_matvecs = 0

    def __repr__(self):
        return (f"InnerSolveStats(solves={self.solves}, "
                f"inner_matvecs={self.inner_matvecs})")


_ACCOUNTS = []     # the open accounting() blocks' records


@contextlib.contextmanager
def accounting():
    """Inside the block, every operator that :func:`shift_invert_operator`
    and :func:`generalized_operator` build counts its inner solves, and the
    ``History`` of every outer solve of ``eigs``, ``eigsh`` and
    ``svds(sigma=)`` is kept: yields ``{"stats": [InnerSolveStats, ...],
    "hist": [History, ...]}`` in the order they were made."""
    seen = {"stats": [], "hist": []}
    _ACCOUNTS.append(seen)
    try:
        yield seen
    finally:
        _ACCOUNTS.remove(seen)


def _new_stats(count=False):
    """An :class:`InnerSolveStats` when ``count`` or inside
    :func:`accounting`, else None."""
    if not (count or _ACCOUNTS):
        return None
    stats = InnerSolveStats()
    for seen in _ACCOUNTS:
        seen["stats"].append(stats)
    return stats


def _note_history(hist):
    """Keep an outer solve's ``History`` in the open accounting blocks."""
    for seen in _ACCOUNTS:
        seen["hist"].append(hist)


def _solver(name):
    try:
        return _SOLVERS[name]
    except KeyError:
        raise ValueError(f"Unknown inner solver {name!r}; expected one of "
                         f"{sorted(_SOLVERS) + ['splu']}") from None


def _operator(A, dtype, device):
    """``as_operator``, with an integer-valued ``A`` promoted as the
    drivers promote it (``device.solver_dtype``)."""
    a_dtype = getattr(A, "dtype", None)
    if dtype is None and a_dtype is not None and not is_inexact(a_dtype):
        dtype = solver_dtype(a_dtype)
    return as_operator(A, dtype=dtype, device=device)


def _shifted_dtype(op_dtype, sigma):
    """The transformed operator's dtype: complex for a complex shift."""
    return op_dtype.to_complex() if (np.iscomplexobj(sigma)
                                     and not op_dtype.is_complex) else op_dtype


def _apply(op, x):
    """``op @ x``; a complex ``x`` through a real operator as its real and
    imaginary parts, two rows of one ``matmat_rows`` call."""
    if x.is_complex() and not op.dtype.is_complex:
        Y = op.matmat_rows(torch.stack([x.real, x.imag]))
        return torch.complex(Y[0], Y[1])
    return op.matvec(x)


def _counted_solve(solver, inner_tol, maxiter, stats, M=None):
    """``solve(matvec, b)`` by the named inner solver, counted into
    ``stats`` (when not None); under ``ARNOLDI_PHASES`` each solve is the
    span ``inner.solve``, its count the products it made."""
    solve_fn = _solver(solver)
    extra = {"restart": GMRES_RESTART} if solver == "gmres" else {}
    clock = phase_clock()

    def solve(matvec, b):
        with clock("inner.solve") as phase:
            x, info = solve_fn(matvec, b, tol=inner_tol, maxiter=maxiter, M=M,
                               **extra)
            phase.count = info.matvecs
        if stats is not None:
            stats.solves += 1
            stats.inner_matvecs += info.matvecs
        return x

    return solve


def _splu_inverse(A, sigma, dtype, stats, device):
    """``(A - sigma I)^{-1}`` by one SciPy ``splu`` factorization of the
    host matrix, in float64 or complex128 whatever the work dtype (ARPACK's
    strategy, and the robust one for indefinite shifts).  Each application
    copies ``b`` to the host, solves there and copies ``x`` back to ``b``'s
    device."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    if not (sp.issparse(A) or isinstance(A, np.ndarray)):
        raise ValueError(
            "solver='splu' factorizes A on the host: pass A as a SciPy sparse "
            f"matrix or a NumPy array, not a {type(A).__name__}")
    device = _require_device(device, "shift_invert_operator(solver='splu')")
    A_h = sp.csc_matrix(A)
    if np.iscomplexobj(sigma) and not np.issubdtype(A_h.dtype,
                                                    np.complexfloating):
        A_h = A_h.astype(np.complex128)
    complex_lu = np.issubdtype(A_h.dtype, np.complexfloating) \
        or np.iscomplexobj(sigma)
    hp = np.complex128 if complex_lu else np.float64
    n = A_h.shape[0]
    lu = splu((A_h.astype(hp) - sigma * sp.identity(n, dtype=hp,
                                                    format="csc")).tocsc())
    op_dtype = torch_dtype(dtype) if dtype is not None else solver_dtype(A_h.dtype)
    clock = phase_clock()

    def host_solve(b):
        if stats is not None:
            stats.solves += 1
        with clock("inner.solve"):
            bh = b.cpu().numpy()
            if np.iscomplexobj(bh) and not complex_lu:
                # Real factorization, complex right-hand side: the parts apart.
                x = (lu.solve(bh.real.astype(np.float64))
                     + 1j * lu.solve(bh.imag.astype(np.float64)))
            else:
                x = lu.solve(bh.astype(hp))
            return torch.from_numpy(x.astype(bh.dtype)).to(b.device)

    return CallableOperator(host_solve, (n, n), op_dtype, nnz=int(A_h.nnz),
                            device=device)


def shift_invert_operator(A, sigma, *, solver="bicgstab", inner_tol=1e-10,
                          maxiter=2000, M=None, dtype=None, count_inner=False,
                          device=None):
    """Wrap ``(A - sigma I)^{-1}`` as a :class:`CallableOperator` on ``A``'s
    device.

    Parameters
    ----------
    A : operator-like (``as_operator``; SciPy and NumPy input need
        ``device=``); for ``solver="splu"`` a SciPy sparse matrix or NumPy
        array, factorized once on the host.
    sigma : real or complex shift.
    solver : "bicgstab" (general), "gmres" (restart 80; robust for
        indefinite shifts), "cg" (Hermitian definite) or "splu".
    inner_tol, maxiter : inner-solve tolerance (keep it a couple of digits
        tighter than the outer one) and iteration budget (restart cycles
        for gmres); an inner solve that runs out stops where it is.
    M : optional preconditioner, operator-like (iterative solvers).
    count_inner : attach an :class:`InnerSolveStats` as ``.inner_stats``
        (always for ``splu``, which counts solves only).
    """
    stats = _new_stats(count_inner or solver == "splu")
    if solver == "splu":
        si_op = _splu_inverse(A, np.asarray(sigma).item(), dtype, stats, device)
        si_op.inner_stats = stats
        return si_op

    op = _operator(A, dtype, device)
    n = op.shape[0]
    sigma = np.asarray(sigma).item()      # keeps a complex shift complex
    precond = None if M is None else as_operator(M, device=op.device).matvec
    solve = _counted_solve(solver, inner_tol, maxiter, stats, M=precond)

    def shifted_mv(x):
        return torch.add(_apply(op, x), x, alpha=-sigma)   # one launch

    si_op = CallableOperator(lambda b: solve(shifted_mv, b), (n, n),
                             _shifted_dtype(op.dtype, sigma), nnz=op.nnz,
                             device=op.device)
    si_op.inner_stats = stats
    return si_op


def _transform_back(theta, sigma, mode="normal"):
    if mode == "buckling":
        return sigma * theta / (theta - 1.0)
    if mode == "cayley":
        return sigma * (theta + 1.0) / (theta - 1.0)
    return sigma + 1.0 / theta


def _is_complex(A):
    if torch.is_tensor(A):
        return A.is_complex()
    a_dtype = getattr(A, "dtype", None)
    if a_dtype is None:
        a_dtype = np.asarray(A).dtype
    return np.issubdtype(np.dtype(a_dtype), np.complexfloating)


def realify_operator(A, dtype=None, *, device=None):
    """Real 2n x 2n representation ``R = [[Ar, -Ai], [Ai, Ar]]`` of a
    COMPLEX matrix (SciPy sparse, NumPy or a torch tensor), acting on
    stacked ``[Re x; Im x]``: A's spectrum with its conjugates, and a
    complex eigenvector ``[w1; w2]`` of R for an eigenvalue of A gives
    A's as ``w1 + i w2``.  ``dtype`` (real or complex) sets the parts'
    real dtype.  Each product applies Ar and Ai to both halves at once."""
    import scipy.sparse as sp

    if not _is_complex(A):
        raise TypeError("realify_operator expects a complex operator")
    n = A.shape[0]
    rdt = None
    if dtype is not None:
        d = numpy_dtype(dtype) if isinstance(dtype, torch.dtype) else np.dtype(dtype)
        rdt = np.finfo(d).dtype if np.issubdtype(d, np.complexfloating) else d
    if sp.issparse(A):
        C = sp.csr_matrix(A)
        parts = (C.real.tocsr(), C.imag.tocsr())
    elif torch.is_tensor(A):
        parts = (A.real.contiguous(), A.imag.contiguous())
    else:
        C = np.asarray(A)
        parts = (np.ascontiguousarray(C.real), np.ascontiguousarray(C.imag))
    Ar, Ai = (as_operator(P, dtype=rdt, device=device) for P in parts)

    def mv(u):
        halves = torch.stack([u[:n], u[n:]])
        P, Q = Ar.matmat_rows(halves), Ai.matmat_rows(halves)
        return torch.cat([P[0] - Q[1], Q[0] + P[1]])

    return CallableOperator(mv, (2 * n, 2 * n), Ar.dtype, nnz=Ar.nnz + Ai.nnz,
                            device=Ar.device)


def eigs_realified(A, k=6, *, which="LM", tol=None, ncv=None, maxiter=1000,
                   dtype=None, ortho="cgs_dgks", generator=None, v0=None,
                   block_size=2, return_eigenvectors=True, device=None):
    """Eigenpairs of a COMPLEX matrix computed in real arithmetic through
    :func:`realify_operator` (the JAX package's route on the complex-free
    TPU; ported for parity).

    2k Schur pairs of R are solved (conjugation doubles every
    multiplicity); a candidate ``z = w1 + i w2`` is dropped when its norm
    vanishes (a conjugate copy), when its residual against A, taken through
    R on the device, exceeds ``max(100 tol, 1e-6)``, or when it repeats a
    kept one (close value and ``|<z', z>| > 0.99``).
    """
    if which not in ("LM", "LR", "SM", "SR"):
        raise NotImplementedError(
            f"which={which!r} is not conjugation-invariant: the realified "
            "spectrum contains conj(lambda) copies that would displace the "
            "wanted set; use LM/LR/SM/SR, or eigs on the complex path")
    R = realify_operator(A, dtype=dtype, device=device)
    n = R.shape[0] // 2
    sort_function = sort_function_for(which)
    if v0 is not None:
        v0 = v0.cpu().numpy() if torch.is_tensor(v0) else np.asarray(v0)
        if v0.shape != (n,):
            raise ValueError(f"v0 must have length {n}, got {v0.shape}")
        v0 = np.concatenate([np.real(v0), np.imag(v0)])
    Q, T, _ = partial_schur(
        R, 2 * k, max_dim=2 * ncv if ncv else None, stopping_criterion=tol,
        sort_function=sort_function, max_restarts=maxiter, ortho=ortho,
        generator=generator, v0=v0, block_size=block_size)
    vals2, vecs2 = eigenpairs_from_partial_schur(Q, T)

    tol_eff = tol if tol is not None else float(
        np.sqrt(np.finfo(np.dtype(dtype) if dtype is not None
                         else np.float32).eps))
    res_tol = max(100.0 * tol_eff, 1e-6)
    val_tol = max(10.0 * tol_eff, 1e-9)
    Z = vecs2[:n] + 1j * vecs2[n:]
    nz = torch.linalg.vector_norm(Z, dim=0)
    Zn = Z / torch.where(nz == 0, 1.0, nz)[None, :]
    AZ = R.matmat(torch.cat([Zn.real, Zn.imag]).contiguous())
    AZ = AZ[:n] + 1j * AZ[n:]
    lam = torch.from_numpy(np.asarray(vals2, dtype=np.complex128)).to(AZ)
    res = (torch.linalg.vector_norm(AZ - Zn * lam[None, :], dim=0)
           / torch.clamp(lam.abs(), min=1.0))
    nz, res = nz.cpu().numpy(), res.cpu().numpy()
    overlap = (Zn.conj().T @ Zn).abs().cpu().numpy()

    picked = []
    for i in np.asarray(sort_function(vals2)):
        if nz[i] < 0.1:            # conjugate copy: the projector annihilates it
            continue
        if res[i] > res_tol:
            continue               # a projector survivor that is no eigenpair
        # Dedup by eigenvector direction: a real eigenvalue of A gives two
        # copies in one span; a multiple one independent vectors.
        lam_i = vals2[i]
        if any(abs(lam_i - vals2[j]) < val_tol * max(1.0, abs(lam_i))
               and overlap[j, i] > 0.99 for j in picked):
            continue
        picked.append(i)
        if len(picked) == k:
            break
    vals = np.array([vals2[i] for i in picked])
    vecs = Zn[:, torch.tensor(picked, dtype=torch.long, device=Zn.device)]
    return (vals, vecs) if return_eigenvectors else vals


def generalized_operator(A, B, sigma=None, *, solver="bicgstab",
                         inner_tol=1e-10, maxiter=2000, dtype=None,
                         mode="normal", device=None):
    """Operator of the generalized problem ``A x = lambda B x``, on A's
    device.

    Without ``sigma``: ``B^{-1} A`` (eigenvalues unchanged).  With
    ``sigma``, one of ARPACK's generalized transforms:

    * ``"normal"`` -- ``(A - sigma B)^{-1} B``; ``lambda = sigma + 1/theta``;
    * ``"buckling"`` -- ``(A - sigma B)^{-1} A``;
      ``lambda = sigma theta / (theta - 1)``;
    * ``"cayley"`` -- ``(A - sigma B)^{-1} (A + sigma B)``;
      ``lambda = sigma (theta + 1) / (theta - 1)``.

    The inverse is an inner solve (``solver``, as in
    :func:`shift_invert_operator`), counted inside :func:`accounting`.
    """
    opA = _operator(A, dtype, device)
    opB = _operator(B, dtype, opA.device)
    n = opA.shape[0]
    if opB.shape[0] != n:
        raise ValueError(f"A is {opA.shape}, B is {opB.shape}")
    solve = _counted_solve(solver, inner_tol, maxiter, _new_stats())

    if sigma is None:
        def mv(x):
            return solve(lambda v: _apply(opB, v), _apply(opA, x))
    else:
        sig = np.asarray(sigma).item()

        def shifted(x):
            return _apply(opA, x) - sig * _apply(opB, x)

        if mode == "buckling":
            def rhs(x):
                return _apply(opA, x)
        elif mode == "cayley":
            def rhs(x):
                return _apply(opA, x) + sig * _apply(opB, x)
        else:
            def rhs(x):
                return _apply(opB, x)

        def mv(x):
            return solve(shifted, rhs(x))

    return CallableOperator(mv, (n, n), _shifted_dtype(opA.dtype, sigma),
                            nnz=opA.nnz + opB.nnz, device=opA.device)


def _explicit_pencil_operator(op, M, sigma, Minv, OPinv, dtype,
                              mode="normal"):
    """SciPy's user-supplied inverses: the outer operator built from
    ``Minv`` (the inverse of M, used when ``sigma`` is None) or ``OPinv``
    (the inverse of ``A - sigma M`` or ``A - sigma I``, used with
    ``sigma``), replacing the inner solve.  None when neither is given.
    Validation mirrors ``scipy.sparse.linalg.eigs``."""
    if OPinv is not None:
        if sigma is None:
            raise ValueError("OPinv should not be specified "
                             "unless sigma is specified")
        opinv = as_operator(OPinv, dtype=dtype, device=op.device)
        if M is None and mode == "normal":
            return opinv
        opM = as_operator(M, dtype=dtype, device=op.device) if M is not None else None
        sig = np.asarray(sigma).item()
        if mode == "buckling":
            def rhs(x):
                return _apply(op, x)
        elif mode == "cayley":
            def rhs(x):
                return _apply(op, x) + sig * _apply(opM, x)
        else:
            def rhs(x):
                return _apply(opM, x)
        return CallableOperator(
            lambda x: _apply(opinv, rhs(x)), op.shape, op.dtype,
            nnz=opinv.nnz + op.nnz + (opM.nnz if opM is not None else 0),
            device=op.device)
    if Minv is not None:
        if sigma is not None:
            raise ValueError("Minv should not be specified "
                             "when sigma is specified (supply OPinv)")
        if M is None:
            raise ValueError("Minv should not be specified with M = None")
        opMinv = as_operator(Minv, dtype=dtype, device=op.device)
        return CallableOperator(
            lambda x: _apply(opMinv, _apply(op, x)), op.shape, op.dtype,
            nnz=opMinv.nnz + op.nnz, device=op.device)
    return None


def _host_lu(inner_solver, sigma, M, Minv, OPinv):
    """Whether a driver's transformed operator is the host LU of A alone
    (``inner_solver="splu"``, a shift, no pencil and no explicit inverse):
    then it never builds a device copy of A, which no product would use."""
    return (inner_solver == "splu" and sigma is not None and M is None
            and Minv is None and OPinv is None)


def _take(vals, vecs, order):
    """``vals[order]`` and the matching columns of the tensor ``vecs``."""
    order = np.asarray(order)
    index = torch.from_numpy(order.astype(np.int64)).to(vecs.device)
    return np.asarray(vals)[order], vecs[:, index]


def _schur_eigenpairs(gop, k, outer, *, tol, ncv, maxiter, ortho, dtype,
                      generator, v0):
    """``(values, vectors)`` of ``partial_schur`` on ``gop`` (which may be
    a transformed operator) under the sort ``outer``."""
    if outer in ("LI", "SI") and dtype is None and not gop.dtype.is_complex:
        # Not conjugation-invariant: a real Schur form keeps each wanted
        # value with its unwanted conjugate.  Solve in the complex dtype,
        # as the JAX package's CPU backend solves every problem, with the
        # real operator applied to the parts.
        real_op = gop
        gop = CallableOperator(lambda x: _apply(real_op, x), real_op.shape,
                               real_op.dtype.to_complex(), nnz=real_op.nnz,
                               device=real_op.device)
    Q, T, hist = partial_schur(
        gop, k, max_dim=ncv, stopping_criterion=tol, sort_function=outer,
        max_restarts=maxiter, ortho=ortho, dtype=dtype, generator=generator,
        v0=v0)
    _note_history(hist)
    theta, vecs = eigenpairs_from_partial_schur(Q, T)
    return np.asarray(theta), vecs


@solve_span()
def eigs(A, k=6, *, which="LM", sigma=None, M=None, Minv=None, OPinv=None,
         tol=None, ncv=None, maxiter=1000, dtype=None, ortho="cgs_dgks",
         generator=None, v0=None, return_eigenvectors=True,
         inner_solver="bicgstab", inner_tol=None, device=None):
    """``scipy.sparse.linalg.eigs`` on the Krylov-Schur driver.

    ``sigma`` runs shift-invert: the eigenvalues of A nearest ``sigma``
    (the outer solve takes LM on ``(A - sigma I)^{-1}``).  ``M`` poses the
    generalized problem ``A x = lambda M x`` (inner solves against M, or
    against ``A - sigma M`` with ``sigma``).  ``Minv``/``OPinv`` give those
    inverses as operators (SciPy's surface) and skip the inner solves.
    ``ncv`` is ``max_dim``, ``maxiter`` the restart budget.  Returns the
    eigenvalues (NumPy) and eigenvectors ((n, k) tensor on the operator's
    device), or the eigenvalues alone.
    """
    kw = dict(ncv=ncv, maxiter=maxiter, ortho=ortho, dtype=dtype,
              generator=generator, v0=v0)
    if _host_lu(inner_solver, sigma, M, Minv, OPinv):
        tr_op = shift_invert_operator(A, sigma, solver="splu", dtype=dtype,
                                      device=device)
        op = explicit = None
    else:
        op = _operator(A, dtype, device)
        explicit = _explicit_pencil_operator(op, M, sigma, Minv, OPinv, dtype)
    if M is not None or sigma is not None:
        if tol is None:
            tol = default_invariant_tol((tr_op if op is None else op).dtype)
        itol = inner_tol if inner_tol is not None else tol * 1e-2
        if explicit is not None:
            tr_op = explicit
        elif M is not None:
            tr_op = generalized_operator(op, M, sigma, solver=inner_solver,
                                         inner_tol=itol, dtype=dtype)
        elif op is not None:              # else the host LU, built above
            tr_op = shift_invert_operator(op, sigma, solver=inner_solver,
                                          inner_tol=itol, dtype=dtype)
        theta, vecs = _schur_eigenpairs(
            tr_op, k, "LM" if sigma is not None else which, tol=tol, **kw)
        vals = _transform_back(theta, sigma) if sigma is not None else theta
        if len(vals) > k:
            # With sigma, trim by the transformed criterion (largest |theta|
            # is nearest sigma), not by `which` on the values: a straddling
            # conjugate pair could evict the value nearest sigma.
            order = (np.argsort(-np.abs(theta))[:k] if sigma is not None
                     else np.asarray(sort_function_for(which)(vals))[:k])
            vals, vecs = _take(vals, vecs, order)
    else:
        vals, vecs = _schur_eigenpairs(op, k, which, tol=tol, **kw)
        # SciPy's contract: exactly k pairs (a real solve may carry k + 1
        # when a conjugate pair straddles the cut).
        if len(vals) > k:
            vals, vecs = _take(vals, vecs,
                               np.asarray(sort_function_for(which)(vals))[:k])
    vals = np.asarray(vals)
    return (vals, vecs) if return_eigenvectors else vals


def _canonical_phase(vecs):
    """Each column rotated so that its largest component is real and
    positive, then its real part: a real pencil's eigenvector returned
    complex by a transient complex Ritz pair carries a stray unit phase."""
    idx = torch.argmax(vecs.abs(), dim=0)
    anchor = vecs.gather(0, idx[None, :])[0]
    mag = anchor.abs()
    phase = anchor / torch.where(mag == 0, 1.0, mag)
    return (vecs * phase.conj()[None, :]).real.contiguous()


@solve_span()
def eigsh(A, k=6, *, which="LM", sigma=None, M=None, Minv=None, OPinv=None,
          mode="normal", tol=None, ncv=None, maxiter=1000, dtype=None,
          generator=None, v0=None, return_eigenvectors=True,
          inner_solver="cg", inner_tol=None, block_size=1, device=None):
    """``scipy.sparse.linalg.eigsh`` on the thick-restart Lanczos driver
    (Hermitian A).

    ``sigma`` runs shift-invert through ``partial_eigh``; ``which`` then
    selects on the transformed values ``1/(lambda - sigma)`` (SciPy's
    contract: "LM" is nearest sigma).  ``M`` poses the symmetric-definite
    pencil ``A x = lambda M x``, solved through :func:`generalized_operator`
    on the Krylov-Schur driver; its eigenvectors come back B-orthonormal
    (B = A in buckling mode, M otherwise).  ``mode`` is ARPACK's transform
    ("normal", "buckling", "cayley"; the latter two need ``sigma`` and
    ``M``).  ``which="BE"`` returns ``k - k//2`` pairs from the top and
    ``k//2`` from the bottom, by two solves.  Eigenvalues ascending (NumPy),
    eigenvectors an (n, k) tensor on the operator's device.
    """
    if mode not in ("normal", "buckling", "cayley"):
        raise ValueError(
            f"mode={mode!r}: expected 'normal', 'buckling' or 'cayley'")
    if mode != "normal":
        if sigma is None:
            raise ValueError(f"mode={mode!r} requires sigma")
        if M is None:
            raise ValueError(f"mode={mode!r} requires M (generalized "
                             "problem)")
    if which == "BE":
        n_lo = k // 2
        kw = dict(sigma=sigma, M=M, Minv=Minv, OPinv=OPinv, mode=mode,
                  tol=tol, ncv=ncv, maxiter=maxiter, dtype=dtype,
                  generator=generator, v0=v0, return_eigenvectors=True,
                  inner_solver=inner_solver, inner_tol=inner_tol,
                  block_size=block_size, device=device)
        vals, vecs = eigsh(A, k - n_lo, which="LA", **kw)
        if n_lo:
            vals_lo, vecs_lo = eigsh(A, n_lo, which="SA", **kw)
            vals = np.concatenate([vals_lo, vals])
            vecs = torch.cat([vecs_lo, vecs], dim=1)
        vals, vecs = _take(vals, vecs, np.argsort(vals))
        return (vals, vecs) if return_eigenvectors else vals

    if _host_lu(inner_solver, sigma, M, Minv, OPinv):
        solve_op = shift_invert_operator(A, sigma, solver="splu", dtype=dtype,
                                         device=device)
        op = explicit = None
    else:
        op = _operator(A, dtype, device)
        explicit = _explicit_pencil_operator(op, M, sigma, Minv, OPinv, dtype,
                                             mode=mode)
    if tol is None and (M is not None or sigma is not None):
        tol = default_invariant_tol((solve_op if op is None else op).dtype)
    itol = inner_tol if inner_tol is not None else (
        None if tol is None else tol * 1e-2)
    if M is not None:
        opM = _operator(M, dtype, op.device)
        gop = explicit if explicit is not None else generalized_operator(
            op, opM, sigma, solver=inner_solver, inner_tol=itol, dtype=dtype,
            mode=mode)
        # `which` acts on the pencil's values (no sigma) or on the
        # transformed ones; both are real, so the symmetric sorts map onto
        # the Krylov-Schur ones.
        smap = {"LA": "LR", "SA": "SR", "LM": "LM", "SM": "SM"}
        if which not in smap:
            raise ValueError(
                f"which={which!r} not supported with M: expected one of "
                f"{('BE',) + tuple(smap)}")
        theta, vecs = _schur_eigenpairs(
            gop, k, smap[which], tol=tol, ncv=ncv, maxiter=maxiter,
            ortho="cgs_dgks", dtype=dtype, generator=generator, v0=v0)
        if len(theta) > k:
            theta, vecs = _take(theta, vecs,
                                np.asarray(sort_function_for(smap[which])(theta))[:k])
        vals = (np.asarray(_transform_back(theta, sigma, mode))
                if sigma is not None else theta).real
        if vecs.is_complex() and not op.dtype.is_complex:
            vecs = _canonical_phase(vecs)
        # SciPy's contract: eigenvectors B-orthonormal (ARPACK's B for
        # dsaupd modes 3-5).
        opB = op if mode == "buckling" else opM
        if vecs.is_complex() and not opB.dtype.is_complex:
            Bv = torch.complex(opB.matmat(vecs.real.contiguous()),
                               opB.matmat(vecs.imag.contiguous()))
        else:
            Bv = opB.matmat(vecs.to(opB.dtype))
        nrm = torch.sqrt((vecs.conj() * Bv).sum(dim=0).real.abs())
        vecs = vecs / torch.where(nrm == 0, 1.0, nrm)[None, :]
    else:
        if sigma is None:
            solve_op = op
        elif op is not None:              # else the host LU, built above
            solve_op = explicit if explicit is not None else \
                shift_invert_operator(op, sigma, solver=inner_solver,
                                      inner_tol=itol, dtype=dtype)
        if sigma is not None and which not in SYM_SORTS:
            raise ValueError(f"which={which!r} not supported with sigma")
        theta, vecs, hist = partial_eigh(
            solve_op, k, which=which, max_dim=ncv, stopping_criterion=tol,
            max_restarts=maxiter, dtype=dtype, generator=generator, v0=v0,
            block_size=block_size)
        _note_history(hist)
        vals = _transform_back(theta, sigma) if sigma is not None else theta
    vals, vecs = _take(vals, vecs, np.argsort(np.asarray(vals)))
    return (vals, vecs) if return_eigenvectors else vals
