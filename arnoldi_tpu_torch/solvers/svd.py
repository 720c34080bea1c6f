"""Partial SVD by thick-restart Lanczos on the Gram operator (``svds``).

Counterpart of ``arnoldi_tpu/solvers/svd.py``: the ``k`` largest
(``which="LM"``) or smallest (``"SM"``) singular triplets of a rectangular
operator, as ``scipy.sparse.linalg.svds`` returns them.  ``partial_eigh``
runs on :class:`~arnoldi_tpu_torch.linop.GramOperator` over the smaller
dimension -- ``A^H A`` for a tall A, ``A A^H`` for a wide one (complex Hermitian for a
complex A) -- so a Lanczos step costs two products and the Gram matrix is
never formed.  Singular
values are ``sqrt(theta)``; the other side is recovered as ``A v / s`` (or
``A^H u / s``) and renormalized.

The adjoint leg is a materialized ``A^H`` operator (:func:`gram_companions`)
built once from the host source, so both legs run the forward kernels; the
legs keep the source's dtype, and a float32 solve below tol 1e-6
(``dtype=float32``) is refined on them in float64 (``solvers/refine.py``).
The JAX package's cast-residual legs ``lo``/``loT`` have no counterpart.
"""

import warnings

import numpy as np
import torch

from ..device import torch_dtype
from ..linop import GramOperator, as_operator, cast_operator, rmatmat
from ..utils.profiling import solve_span
from .decomposition import default_invariant_tol
from .lanczos import partial_eigh

__all__ = ["svds", "gram_companions"]


@solve_span()
def svds(A, k=6, *, which="LM", sigma=None, tol=None, ncv=None,
         maxiter=1000, dtype=None, generator=None, v0=None, block_size=1,
         inner_solver="gmres", inner_tol=None, return_singular_vectors=True,
         return_history=False, companions=None, device=None):
    """Compute ``k`` singular triplets of ``A`` (any shape).

    ``A`` is anything :func:`~arnoldi_tpu_torch.as_operator` takes (SciPy
    and NumPy input need ``device=``).  Returns ``(U, s, Vh)`` like
    ``scipy.sparse.linalg.svds``, with ``s`` ascending (a NumPy array) and
    U (n_rows, k), Vh (k, n_cols) tensors on the operator's device; just
    ``s`` with ``return_singular_vectors=False``; the inner Lanczos
    ``History`` appended with ``return_history=True``.  ``ncv`` is the
    Lanczos ``max_dim``, ``maxiter`` its restart budget, ``dtype`` its
    work dtype, ``tol`` its tolerance (default sqrt(eps) of the work dtype;
    a float32 solve below 1e-6 is refined), ``v0`` a start vector of
    length ``min(A.shape)``.
    ``companions``: a prebuilt :func:`gram_companions` tuple (repeated
    solves on one matrix build the adjoint once).

    ``sigma`` selects the ``k`` singular values nearest ``sigma`` (and
    ``which`` is ignored): shift-invert Lanczos on the Gram operator at
    ``sigma**2`` (inner solves by ``inner_solver``, default gmres, since
    the shifted Gram is indefinite, to ``inner_tol``, default ``tol/100``)
    converges a buffered set of ``k + max(2, k//2)`` values nearest in the
    squared domain, of which the ``k`` nearest ``|sigma|`` in the linear
    domain are kept: ``|s^2 - sigma^2|`` overweights values above sigma.
    """
    if which not in ("LM", "SM"):
        raise ValueError(
            f"which={which!r}: expected 'LM' (largest) or 'SM' (smallest)")

    op = as_operator(A, device=device)
    n_rows, n_cols = op.shape
    transposed = n_rows < n_cols
    gram_dim = n_rows if transposed else n_cols
    if companions is None:
        companions = gram_companions(A, op) or (None,)
    gram = GramOperator(op, *companions, transposed=transposed, nnz=op.nnz)
    if v0 is not None and tuple(np.shape(v0)) != (gram_dim,):
        raise ValueError(f"v0 must have length {gram_dim}, got "
                         f"{tuple(np.shape(v0))}")
    if tol is None:
        # sqrt(eps) of the work dtype, as JAX's operator built in ``dtype``
        # gets it: a float32 solve then stops at the float32 floor.
        tol = default_invariant_tol(torch_dtype(dtype) if dtype is not None
                                    else op.dtype)

    if sigma is None:
        theta, W, hist = partial_eigh(
            gram, k, which="LA" if which == "LM" else "SA", max_dim=ncv,
            stopping_criterion=tol, max_restarts=maxiter, dtype=dtype,
            generator=generator, v0=v0, block_size=block_size)
    else:
        theta, W, hist = _nearest_sigma(
            gram, k, sigma, ncv=ncv, tol=tol, maxiter=maxiter, dtype=dtype,
            generator=generator, v0=v0, block_size=block_size,
            inner_solver=inner_solver, inner_tol=inner_tol)
    theta = np.maximum(np.asarray(theta, dtype=np.float64), 0.0)
    order = np.argsort(theta)            # scipy returns s ascending
    s = np.sqrt(theta[order])
    if not return_singular_vectors:
        return (s, hist) if return_history else s

    W = W[:, torch.from_numpy(order).to(W.device)]
    side = cast_operator(op, W.dtype)
    safe = torch.from_numpy(np.where(s == 0, 1.0, s)).to(W)
    if transposed:
        # gram = A A^H: W holds left singular vectors; V = A^H U / s.
        U = W
        AhU = (cast_operator(gram.opT, W.dtype).matmat(U)
               if gram.opT is not None else rmatmat(side, U))
        V = _renormalize(AhU / safe[None, :])
    else:
        # gram = A^H A: W holds right singular vectors; U = A V / s.
        V = W
        U = _renormalize(side.matmat(V) / safe[None, :])
    out = (U, s, V.conj().T.contiguous())
    return out + (hist,) if return_history else out


def _nearest_sigma(gram, k, sigma, *, ncv, tol, maxiter, dtype, generator,
                   v0, block_size, inner_solver, inner_tol):
    """``(theta, W, history)``: the k Gram eigenpairs whose square roots
    are nearest ``|sigma|``, by shift-invert ``partial_eigh`` at
    ``sigma**2`` on a buffered set (the JAX package's
    ``arnoldi_tpu/solvers/svd.py:87-123``)."""
    from .spectral_transform import (_note_history, _transform_back,
                                     shift_invert_operator)

    sig2 = float(np.real(sigma)) ** 2
    itol = inner_tol if inner_tol is not None else tol * 1e-2
    si = shift_invert_operator(gram, sig2, solver=inner_solver,
                               inner_tol=itol, dtype=dtype)
    kk = k + max(2, k // 2)
    if ncv is not None:
        kk = min(kk, ncv - 1)
    kk = max(k, min(kk, gram.shape[0] - 1))
    nu, W, hist = partial_eigh(
        si, kk, which="LM", max_dim=ncv, stopping_criterion=tol,
        max_restarts=maxiter, dtype=dtype, generator=generator, v0=v0,
        block_size=block_size)
    _note_history(hist)
    theta = np.asarray(_transform_back(np.asarray(nu), sig2)).real
    if kk > k:
        sv_lin = np.sqrt(np.maximum(theta, 0.0))
        pick = np.argsort(np.abs(sv_lin - abs(float(np.real(sigma)))),
                          kind="stable")[:k]
        theta = theta[pick]
        W = W[:, torch.from_numpy(pick).to(W.device)]
    return theta, W, hist


def gram_companions(A_src, op):
    """``(opT,)``: the materialized adjoint ``A^H`` of a SciPy sparse or
    NumPy ``A_src``, built on the host (``A.conj().T.tocsr()``) in ``op``'s
    dtype on ``op``'s device, so that the Gram's adjoint leg runs the same
    forward kernels as ``op``.  None for any other source (an operator or a
    closure), and, with a ``RuntimeWarning``, when the adjoint has no padded
    layout (a few dense columns of A are dense rows of A^H): the Gram then
    takes :func:`~arnoldi_tpu_torch.linop.rmatvec`, which on the card
    builds the same transpose and fails the same way."""
    import scipy.sparse as sp

    if sp.issparse(A_src):
        At = sp.csr_matrix(A_src).conj().T.tocsr()
    elif isinstance(A_src, np.ndarray):
        At = np.ascontiguousarray(A_src.conj().T)
    else:
        return None
    try:
        opT = as_operator(At, dtype=op.dtype, device=op.device)
    except ValueError as e:
        warnings.warn(
            "svds: no device layout for the adjoint operator; the Gram's "
            f"adjoint leg falls back to rmatvec ({e})", RuntimeWarning,
            stacklevel=3)
        return None
    return (opT,)


def _renormalize(X):
    """Unit columns (guards tiny-sigma roundoff); a zero column, an exact
    null-space direction recovered with sigma = 0, is left as it is."""
    norms = torch.linalg.vector_norm(X, dim=0)
    return X / torch.where(norms == 0, 1.0, norms)[None, :]
