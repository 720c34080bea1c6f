"""Orthogonalization kernels with the ``(h, w, beta, breakdown)`` contract.

Counterpart of ``arnoldi_tpu/ops/ortho.py`` for the Krylov-Schur drivers.
Every scalar kernel orthogonalizes ``w`` against the first ``n_active``
rows of the transposed basis ``Vt: (m+1, n)`` and returns

* ``h`` -- (m+1,) projection coefficients, zero past ``n_active``;
* ``w`` -- the orthogonalized, not normalized, vector;
* ``beta`` -- ``||w||`` as a 0-d tensor;
* ``breakdown`` -- ``beta < tol`` as a 0-d bool tensor.

The classical ones are built from the two fused passes of
``ops/kernels/ortho_fused.py``, which launch the CUDA kernels on CUDA
tensors and run their plain PyTorch versions on CPU tensors;
:func:`mgs_dgks` is plain PyTorch. The DGKS test of :func:`cgs_dgks` is a
host ``if`` on a 0-d tensor, so it waits for the device once per call (the
JAX version keeps it on the device with ``lax.cond``).

:func:`block_cgs2`, the block driver's kernel, orthogonalizes b rows at
once with ``torch.matmul`` projections and CholQR2, and returns
``(C, Q, R, breakdown)``.
"""

import math
from functools import partial

import torch

from .kernels.ortho_fused import cgs2_fused, masked_project, project_update_norm

#: DGKS re-orthogonalization threshold, eta = sqrt(1/2).
M_SQRT1_2 = math.sqrt(0.5)


def _reduce(t, mesh):
    """The sum of ``t`` over the mesh's ranks (``t`` without a mesh)."""
    return t if mesh is None else mesh.all_reduce(t)


def vector_norm(w, mesh=None):
    """``||w||`` as a 0-d tensor; under a mesh the norm of the whole vector
    whose rows the ranks hold (the local squares summed over the ranks)."""
    if mesh is None:
        return torch.linalg.vector_norm(w)
    sq = torch.vdot(w, w).real if w.is_complex() else torch.dot(w, w)
    return torch.sqrt(mesh.all_reduce(sq))


def _project(Vt, w, n_active, mesh=None):
    c = _reduce(masked_project(Vt, w, n_active), mesh)
    w, norm_sq = project_update_norm(Vt, w, c, n_active)
    return c, w, torch.sqrt(_reduce(norm_sq, mesh))


def cgs_dgks(Vt, w, n_active, *, tol=1e-8, eta=M_SQRT1_2, mesh=None):
    """Classical Gram-Schmidt with one DGKS-controlled second pass, taken
    when ``beta1 < eta * ||w||``; ``eta <= 0`` never takes it.

    Under a ``mesh`` (``Vt`` and ``w`` this rank's columns) the projection
    coefficients and the squared norms are summed over the ranks, the two
    norms of the first pass in one all-reduce; the kernels are unchanged."""
    c1 = _reduce(masked_project(Vt, w, n_active), mesh)
    w1, norm1_sq = project_update_norm(Vt, w, c1, n_active)
    if eta > 0:
        # ||w|| from the update pass over no rows: w' = w, plus its norm.
        _, beta_before_sq = project_update_norm(Vt, w, c1, 0)
        if mesh is not None:
            norm1_sq, beta_before_sq = mesh.all_reduce(
                torch.stack([norm1_sq, beta_before_sq]))
        beta1 = torch.sqrt(norm1_sq)
        if bool(beta1 < eta * torch.sqrt(beta_before_sq)):
            c2, w1, beta1 = _project(Vt, w1, n_active, mesh)
            c1 = c1 + c2
    else:
        beta1 = torch.sqrt(_reduce(norm1_sq, mesh))
    return c1, w1, beta1, beta1 < tol


def mgs_dgks(Vt, w, n_active, *, tol=1e-8, eta=M_SQRT1_2, mesh=None):
    """Modified Gram-Schmidt with one DGKS-controlled second pass, taken
    when ``beta1 < eta * ||w||``; ``eta <= 0`` never takes it.

    Sequential by construction: a Python loop over the ``n_active`` rows,
    one dot and one axpy each (each dot summed over the ranks under a
    ``mesh``).  Kept for parity and cross-validation with the classical
    kernels, so it has no kernel of its own.
    """
    n_active = int(n_active)
    h = torch.zeros(Vt.shape[0], dtype=Vt.dtype, device=Vt.device)

    def one_pass(w):
        for i in range(n_active):
            c = _reduce(torch.vdot(Vt[i], w), mesh)
            w = w - c * Vt[i]
            h[i] += c
        return w

    beta_before = vector_norm(w, mesh)
    w = one_pass(w)
    beta = vector_norm(w, mesh)
    if eta > 0 and bool(beta < eta * beta_before):
        w = one_pass(w)
        beta = vector_norm(w, mesh)
    return h, w, beta, beta < tol


#: Twice-is-enough CGS: both passes always run.
cgs2 = cgs2_fused


def block_cgs2(Vt, W, n_active, *, tol=1e-8, mesh=None):
    """Block classical Gram-Schmidt (two passes) + CholQR2 within the block.

    Counterpart of ``block_cgs2`` in ``arnoldi_tpu/ops/ortho.py``.  The b
    rows of ``W`` are projected out of the first ``n_active`` rows of ``Vt``
    twice (two gemm pairs over exactly the active rows; the JAX version
    masks the whole workspace), then orthonormalized by Cholesky-QR applied
    twice on the b x b Gram matrix.  Complex blocks take the Hermitian
    inner products: ``C = conj(V) W^T``, ``G = W W^H``.

    Parameters
    ----------
    Vt : (m+b, n) transposed basis workspace; rows past ``n_active`` are
        never read.
    W : (b, n) block to orthogonalize (rows are vectors).
    n_active : valid leading rows of ``Vt``.
    mesh : under a row mesh ``Vt`` and ``W`` are this rank's columns; the
        projections and the Gram matrices are summed over the ranks, so
        every rank factors the same Gram and gets the same C, R and flag.

    Returns
    -------
    C : (m+b, b) projection coefficients of both passes, zero past
        ``n_active`` (column j belongs to W's j-th row).
    Q : (b, n) orthonormalized block.
    R : (b, b) upper triangular, ``W_proj = R^T Q`` in rows.
    breakdown : 0-d bool tensor on the device: the block was numerically
        rank deficient.  No host sync happens here.
    """
    n_active = int(n_active)
    V = Vt[:n_active]
    # conj is the identity on real tensors; C = conj(V) W^T, W - C^T V.
    C1 = _reduce(V.conj() @ W.T, mesh)    # (n_active, b)
    W = W - C1.T @ V
    C2 = _reduce(V.conj() @ W.T, mesh)
    W = W - C2.T @ V
    C = torch.zeros((Vt.shape[0], W.shape[0]), dtype=Vt.dtype, device=Vt.device)
    C[:n_active] = C1 + C2

    b = W.shape[0]
    finfo = torch.finfo(Vt.dtype)
    eye = torch.eye(b, dtype=Vt.dtype, device=Vt.device)

    def cholqr(W):
        G = _reduce(W @ W.mH, mesh)
        # Shift relative to the block's own scale (floored at tiny so an
        # all-zero block stays finite), so a small but healthy block is
        # still normalized; rank deficiency is read off the diagonal.
        scale = torch.clamp(G.diagonal().abs().max(), min=finfo.tiny)
        # cholesky_ex does not raise on a Gram that is not positive
        # definite (JAX returns NaN there); info > 0 reads as breakdown.
        L, info = torch.linalg.cholesky_ex(G + (finfo.eps * scale) * eye)
        # Q = L^-1 W as one gemm with the inverted b x b factor: a triangular
        # solve with the n columns of W as right-hand sides took 5-7 s at
        # n = 2^20 on an H100 (0.2 ms at n = 524,176), the gemm 0.2 ms.
        L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
        return L_inv @ W, L, info

    Q, L1, info1 = cholqr(W)
    Q, L2, info2 = cholqr(Q)
    R = (L1 @ L2).T       # a plain transpose for complex blocks too, as in JAX
    diag = L1.diagonal().abs()
    # Rank deficiency: a diagonal entry below the absolute tolerance or
    # below 10 sqrt(eps) of the block's largest; a non-finite diagonal or a
    # failed factorization reads as breakdown too.
    rel_floor = 10.0 * finfo.eps ** 0.5 * diag.max()
    breakdown = ((diag.min() < torch.clamp(rel_floor, min=tol))
                 | ~torch.isfinite(diag).all() | (info1 != 0) | (info2 != 0))
    return C, Q, R, breakdown

#: Registry used by the solver drivers (``ortho=``).  ``"cgs2_pallas"``
#: names the same function as ``"cgs2"``, so one ``ortho=`` value drives
#: both packages in the parity tests.  :func:`block_cgs2` has another
#: contract and is called by the block driver directly.
ORTHO_KERNELS = {
    "cgs_dgks": cgs_dgks,
    "mgs_dgks": mgs_dgks,
    "cgs2": cgs2,
    "cgs": partial(cgs_dgks, eta=0.0),
    "mgs": partial(mgs_dgks, eta=0.0),
    "cgs2_pallas": cgs2,
}


def resolve_ortho(name_or_fn, mesh=None):
    """The ortho kernel a name (or a callable) stands for; under a ``mesh``
    it is called with ``mesh=`` (a callable must take it)."""
    if callable(name_or_fn):
        fn = name_or_fn
    else:
        try:
            fn = ORTHO_KERNELS[name_or_fn]
        except KeyError:
            raise ValueError(
                f"Unknown orthogonalization kernel {name_or_fn!r}; expected one "
                f"of {sorted(ORTHO_KERNELS)} or a callable"
            ) from None
    return fn if mesh is None else partial(fn, mesh=mesh)
