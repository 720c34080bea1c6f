"""Explicit-restart Arnoldi drivers: naive and deflation/locking.

Counterpart of ``arnoldi_tpu/solvers/explicit_restarts.py`` (the reference
library's ``explicit_restarts.py``):

* :func:`naive_explicit_restarts` -- one eigenvalue: expand to m, restart
  from the dominant Ritz vector, accept when both the approximate and the
  true relative residual pass (Saad's table 6.2);
* :func:`explicit_restarts_with_deflation` -- nev eigenpairs one at a
  time, each converged vector locked into the leading rows of the basis
  (later expansions orthogonalize against it and never modify it), its
  column of the projected H built by Rayleigh quotients at lock time, and
  the locked ``H`` re-diagonalized at the end.

The expansions, Ritz vectors and orthogonalization against the locked rows
run on the operator's device (the kernels of ``decomposition`` and
``ops/ortho``); the small eigenproblems and the bookkeeping on the host.
The work dtype is complex by default (``result_type(op.dtype,
complex64)``), as in the JAX package; a real operator then stays real and
is applied to the real and imaginary parts of a vector as two columns of
its b-column kernel, never cast to complex.

Two faults of the reference's completeness backstop are not copied: an
extra slot that runs out of restarts ends the probe, and the converged
result is returned (the JAX package lets the ``ValueError`` escape); and a
probed value counts as inside the top set within ``max(10 tol, 1e-10)``
relative, not 1e-10, since a Ritz value and its locked Rayleigh quotient
differ by O(tol |lambda|).
"""

import numpy as np
import torch

from ..device import numpy_dtype, solver_dtype, torch_dtype
from ..linop import CallableOperator, cast_operator
from ..ops import dense_tier
from ..ops.ortho import cgs_dgks
from ..utils.history import History
from ..utils.random import rand_normalized_vector
from ..utils.sorting import arg_largest_magnitude, sort_function_for
from .decomposition import RitzDecomposition, arnoldi_expand, default_invariant_tol
from .spectral_transform import _apply, _operator

__all__ = [
    "History",
    "naive_explicit_restarts",
    "explicit_restarts_with_deflation",
    "mgs_orthogonalize",
]


def _require_real(v, what):
    """A Ritz vector for the real work dtype: a complex one whose imaginary
    part is rounding (below 1e-7 of its largest entry) as its real part;
    a truly complex one raises, where storing it in the real basis would
    drop its imaginary part and lock a non-eigenvector."""
    if not v.is_complex():
        return v
    scale = max(float(v.abs().max()), 1.0)
    if float(v.imag.abs().max()) <= 1e-7 * scale:
        return v.real.contiguous()
    raise ValueError(
        f"{what}: a dominant Ritz pair is complex but the work dtype is "
        "real; use a complex dtype, or partial_schur/eigs (the real Schur "
        "path carries conjugate pairs as 2x2 blocks)")


def _work(A, dtype, device):
    """``(op, wop, wdtype)``: the operator, the work dtype (``dtype``, or
    the complex type of the operator's) and the operator in it (a real
    operator in a complex dtype applied to the parts)."""
    op = _operator(A, None, device)
    if op.shape[1] != op.shape[0]:
        raise ValueError(f"need a square operator, got {op.shape}")
    wdtype = solver_dtype(op.dtype).to_complex() if dtype is None \
        else torch_dtype(dtype)
    if wdtype.is_complex and not op.dtype.is_complex:
        real = cast_operator(op, wdtype.to_real())
        wop = CallableOperator(lambda x: _apply(real, x), op.shape, wdtype,
                               nnz=op.nnz, device=op.device)
    else:
        wop = cast_operator(op, wdtype)
    return op, wop, wdtype


def _ortho_against_locked(V, v, n_locked):
    """``v`` orthonormalized against the first ``n_locked`` rows of ``V``
    (CGS with the DGKS second pass: the fused kernels on the card).
    Returns ``(v_unit, beta)``, ``beta`` the norm before scaling (a host
    float)."""
    if n_locked:
        _, w, beta, _ = cgs_dgks(V, v, n_locked, tol=0.0)
    else:
        w, beta = v, torch.linalg.vector_norm(v)
    beta = float(beta)
    return w / (beta if beta else 1.0), beta


def mgs_orthogonalize(basis, w, tol):
    """The reference's helper: ``w`` orthonormalized against the columns of
    ``basis`` ``(n, k)``; raises ``AssertionError`` if its norm collapses
    to ``tol`` or below."""
    basis_t = torch.as_tensor(basis).T.contiguous()
    w = torch.as_tensor(w).to(basis_t).contiguous()
    v, beta = _ortho_against_locked(basis_t, w, basis_t.shape[0])
    if beta <= tol:
        raise AssertionError("MGS: Too small norm when orthornormalizing")
    return v


def _unit_ritz_vector(v, wdtype, what):
    if not wdtype.is_complex:
        v = _require_real(v, what)
    v = v.to(wdtype)
    return v / torch.linalg.vector_norm(v)


def naive_explicit_restarts(A, m=None, *, stopping_criterion=None,
                            max_restarts=10, ortho="cgs_dgks", dtype=None,
                            generator=None, device=None, _v0=None):
    """Single-eigenvalue explicit restarts (largest magnitude).

    Returns ``(ritz, has_converged, n_restarts)`` like the reference:
    ``ritz`` a :class:`RitzDecomposition` of one pair.  ``generator`` draws
    the start vector (``_v0`` passes one in)."""
    op, wop, wdtype = _work(A, dtype, device)
    n = op.shape[0]
    tol = default_invariant_tol(op.dtype) if stopping_criterion is None \
        else float(stopping_criterion)
    k = 1
    if m is None:
        m = min(max(2 * k + 1, 20), n)
    if _v0 is None:
        v0 = rand_normalized_vector(n, wdtype, device=op.device,
                                    generator=generator)
    else:
        v0 = torch.tensor(np.asarray(_v0), dtype=wdtype, device=op.device)

    ritz = None
    for i in range(max_restarts):
        Vt = torch.zeros((m + 1, n), dtype=wdtype, device=op.device)
        Vt[0] = v0
        H = torch.zeros((m + 1, m), dtype=wdtype, device=op.device)
        Vt, H, n_iter = arnoldi_expand(wop, Vt, H, tol, max_dim=m, ortho=ortho)
        ritz = RitzDecomposition.from_vt_and_h(Vt, H, k, max_dim=n_iter)
        if ritz.approximate_residuals[0] < tol:
            residuals = ritz.compute_true_residuals(op)
            if residuals[0] / max(abs(ritz.values[0]), tol) < tol:
                return ritz, True, i
        v0 = _unit_ritz_vector(ritz.vectors[:, 0], wdtype,
                               "naive_explicit_restarts")
    return ritz, False, max_restarts


def _probe_continues(lam_new, H_locked, sort_function, nev, tol):
    """Whether the completeness backstop probes another slot after
    converging ``lam_new``: it ranks inside the top nev of the locked
    values (the eigenvalues of the triangular ``H_locked``, Rayleigh
    quotients) within ``max(10 tol, 1e-10)`` relative, and it did not
    merely swap with its tied-|lambda| twin at the cut."""
    locked_vals = np.linalg.eigvals(H_locked)
    order = np.asarray(sort_function(locked_vals))
    rtol = max(10.0 * tol, 1e-10)
    if not np.any(np.isclose(lam_new, locked_vals[order[:nev]], rtol=rtol,
                             atol=1e-12)):
        return False    # the dominant remaining direction ranks below
    if len(locked_vals) > nev and np.isclose(
            abs(lam_new), abs(locked_vals[order[nev]]), rtol=1e-7, atol=1e-10):
        return False    # either twin at the cut is a correct answer
    return True


def explicit_restarts_with_deflation(
    A, nev, *, max_dim=None, stopping_criterion=None, max_restarts=100,
    sort_function=None, ortho="cgs_dgks", dtype=None, generator=None,
    device=None, _v0s=None,
):
    """``nev`` eigenpairs by explicitly restarted Arnoldi with deflation
    (locking).

    Each slot starts from a unit Gaussian vector from ``generator``
    (``_v0s`` passes the sequence in), orthogonalized against the locked
    rows.  After the nev-th lock, a completeness backstop converges the
    dominant remaining direction while it outranks the nev-th best locked
    value (up to ``3 + nev // 4`` extra slots); the result is the best nev
    of all locked values.  Returns ``(eigenvalues, eigenvectors,
    history)``: values (NumPy), vectors an ``(n, nev)`` tensor on the
    operator's device, and ``History`` with each slot's matvecs and
    restarts.  Raises ``ValueError("Could not converge for value k")`` when
    slot ``k < nev`` runs out of restarts."""
    op, wop, wdtype = _work(A, dtype, device)
    n = op.shape[0]
    dev = op.device
    tol = default_invariant_tol(op.dtype) if stopping_criterion is None \
        else float(stopping_criterion)
    sort_function = sort_function_for(
        arg_largest_magnitude if sort_function is None else sort_function)
    if max_restarts <= 0:
        raise ValueError(f"max_restarts must be positive, got {max_restarts}")
    if max_dim is None:
        max_dim = min(max(2 * nev + 1, 20), n)

    V = torch.zeros((max_dim + 1, n), dtype=wdtype, device=dev)
    H_host = np.zeros((max_dim + 1, max_dim), dtype=numpy_dtype(wdtype))
    history = History.from_k(nev)
    starts = iter(_v0s) if _v0s is not None else None
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def start_vector():
        if starts is not None:
            return torch.tensor(np.asarray(next(starts)), dtype=wdtype,
                                device=dev)
        return rand_normalized_vector(n, wdtype, device=dev,
                                      generator=generator)

    def converge_slot(k):
        """Converge one eigenpair into locked slot ``k`` (the reference's
        per-eigenvalue loop); returns its eigenvalue estimate, or None when
        ``max_restarts`` run out."""
        nonlocal V, H_host
        v0, beta = _ortho_against_locked(V, start_vector(), k)
        if not beta > tol:
            raise ValueError("start vector collapsed onto the locked basis")
        V[k] = v0
        matvecs_k = 0
        for restart in range(max_restarts):
            H = torch.from_numpy(H_host).to(dev)
            V, H, m = arnoldi_expand(wop, V, H, tol, start_dim=k,
                                     max_dim=max_dim, ortho=ortho)
            matvecs_k += m - k
            happy_breakdown = m != max_dim
            H_host = H.cpu().numpy().copy()
            # Ritz pairs of the deflated factorization: rows k..m of V.
            ritz = RitzDecomposition.from_vt_and_h(
                V[k:m + 1], H_host[k:m + 1, k:m], m - k,
                sort_function=sort_function)
            v_k = _unit_ritz_vector(ritz.vectors[:, 0], wdtype,
                                    "explicit_restarts_with_deflation")
            v_k, beta = _ortho_against_locked(V, v_k, k)
            if not beta > tol:
                raise ValueError("Ritz vector collapsed onto the locked basis")
            V[k] = v_k
            approximate = ritz.approximate_residuals / np.abs(ritz.values)
            if happy_breakdown or approximate[0] < tol:
                # lock: column k of the projected H by Rayleigh quotients
                Av = wop.matvec(V[k])
                H_host[: k + 1, k] = (V[: k + 1].conj() @ Av).cpu().numpy()
                H_host[k + 1:-1, k] = 0
                if k < nev:
                    history.matvecs[k] = matvecs_k
                    history.restarts[k] = restart + 1
                else:
                    history.matvecs[-1] += matvecs_k
                    history.restarts[-1] += restart + 1
                return complex(ritz.values[0])
        return None

    for k in range(nev):
        if converge_slot(k) is None:
            raise ValueError(f"Could not converge for value {k}")

    # Completeness backstop: one-at-a-time locking can converge a
    # lower-ranked value when the Krylov window is tight (mark(100) at ncv
    # = 2 nev).  Converge the dominant remaining direction while it ranks
    # inside the top nev of all locked values.
    max_extra = int(min(3 + nev // 4, max_dim - 1 - nev))
    k_lock = nev
    while k_lock < nev + max_extra and k_lock < max_dim - 1:
        lam_new = converge_slot(k_lock)
        if lam_new is None:
            break       # the probe ran out of restarts: keep the result
        k_lock += 1
        if not _probe_continues(lam_new, H_host[:k_lock, :k_lock],
                                sort_function, nev, tol):
            break
    # Re-diagonalize the locked projected matrix (required for Markov-type
    # matrices) and keep the best nev.
    eivals, Y = dense_tier.eig(H_host[:k_lock, :k_lock])
    order = np.asarray(sort_function(np.asarray(eivals)))[:nev]
    eivals = np.asarray(eivals)[order]
    Y = torch.from_numpy(np.ascontiguousarray(np.asarray(Y)[:, order]))
    if not wdtype.is_complex:
        Y = _require_real(Y, "explicit_restarts_with_deflation")
    eivecs = V[:k_lock].T @ Y.to(device=dev, dtype=wdtype)
    return eivals, eivecs, history
