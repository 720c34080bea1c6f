"""Orthogonalization kernels with the ``(h, w, beta, breakdown)`` contract.

Counterpart of ``arnoldi_tpu/ops/ortho.py`` for the Krylov-Schur drivers.
Every scalar kernel orthogonalizes ``w`` against the first ``n_active``
rows of the transposed basis ``Vt: (m+1, n)`` and returns

* ``h`` -- (m+1,) projection coefficients, zero past ``n_active``;
* ``w`` -- the orthogonalized, not normalized, vector;
* ``beta`` -- ``||w||`` as a 0-d tensor;
* ``breakdown`` -- ``beta < tol`` as a 0-d bool tensor.

All of them are built from the two fused passes of
``ops/kernels/ortho_fused.py``, which launch the CUDA kernels on CUDA
tensors and run their plain PyTorch versions on CPU tensors.  The DGKS
test of :func:`cgs_dgks` is a host ``if`` on a 0-d tensor, so it waits for
the device once per call (the JAX version keeps it on the device with
``lax.cond``).

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


def _project(Vt, w, n_active):
    c = masked_project(Vt, w, n_active)
    w, norm_sq = project_update_norm(Vt, w, c, n_active)
    return c, w, torch.sqrt(norm_sq)


def cgs_dgks(Vt, w, n_active, *, tol=1e-8, eta=M_SQRT1_2):
    """Classical Gram-Schmidt with one DGKS-controlled second pass, taken
    when ``beta1 < eta * ||w||``; ``eta <= 0`` never takes it."""
    c1, w1, beta1 = _project(Vt, w, n_active)
    if eta > 0:
        # ||w|| from the update pass over no rows: w' = w, plus its norm.
        _, beta_before_sq = project_update_norm(Vt, w, c1, 0)
        if bool(beta1 < eta * torch.sqrt(beta_before_sq)):
            c2, w1, beta1 = _project(Vt, w1, n_active)
            c1 = c1 + c2
    return c1, w1, beta1, beta1 < tol


#: Twice-is-enough CGS: both passes always run.
cgs2 = cgs2_fused


def block_cgs2(Vt, W, n_active, *, tol=1e-8):
    """Block classical Gram-Schmidt (two passes) + CholQR2 within the block.

    Counterpart of ``block_cgs2`` in ``arnoldi_tpu/ops/ortho.py``.  The b
    rows of ``W`` are projected out of the first ``n_active`` rows of ``Vt``
    twice (two gemm pairs over exactly the active rows; the JAX version
    masks the whole workspace), then orthonormalized by Cholesky-QR applied
    twice on the b x b Gram matrix.

    Parameters
    ----------
    Vt : (m+b, n) transposed basis workspace; rows past ``n_active`` are
        never read.
    W : (b, n) block to orthogonalize (rows are vectors).
    n_active : valid leading rows of ``Vt``.

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
    C1 = V @ W.T                          # (n_active, b)
    W = W - C1.T @ V
    C2 = V @ W.T
    W = W - C2.T @ V
    C = torch.zeros((Vt.shape[0], W.shape[0]), dtype=Vt.dtype, device=Vt.device)
    C[:n_active] = C1 + C2

    b = W.shape[0]
    finfo = torch.finfo(Vt.dtype)
    eye = torch.eye(b, dtype=Vt.dtype, device=Vt.device)

    def cholqr(W):
        G = W @ W.T
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
    R = (L1 @ L2).T
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
#: both packages in the parity tests.  ``mgs_dgks`` and ``mgs`` are not
#: ported yet (ROADMAP.md, Queue 1 item 3).  :func:`block_cgs2` has another
#: contract and is called by the block driver directly.
ORTHO_KERNELS = {
    "cgs_dgks": cgs_dgks,
    "cgs2": cgs2,
    "cgs": partial(cgs_dgks, eta=0.0),
    "cgs2_pallas": cgs2,
}


def resolve_ortho(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn in ("mgs_dgks", "mgs"):
        raise NotImplementedError(
            f"ortho={name_or_fn!r} is not ported yet (ROADMAP.md, Queue 1 "
            "item 3)")
    try:
        return ORTHO_KERNELS[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown orthogonalization kernel {name_or_fn!r}; expected one of "
            f"{sorted(ORTHO_KERNELS)} or a callable"
        ) from None
