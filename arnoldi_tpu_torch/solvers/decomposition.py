"""Arnoldi expansion (the hot loop).

Counterpart of the scalar and block expansions in
``arnoldi_tpu/solvers/decomposition.py``.  The factorization lives in two
tensors updated in place: ``Vt: (m+1, n)`` (the transposed basis, one Krylov
vector per contiguous row) and ``H: (m+1, m)``.  PyTorch runs eagerly and
does not compile per shape, so each step projects against exactly its
``j + 1`` active rows (the JAX version masks a static-shape workspace and
slices it in segments), and a breakdown leaves the Python loop at once
instead of running masked dead steps.
"""

import numpy as np
import torch

from ..ops.ortho import block_cgs2, resolve_ortho


def default_invariant_tol(dtype):
    """sqrt(eps) of ``dtype`` (torch or NumPy)."""
    if isinstance(dtype, torch.dtype):
        return float(np.sqrt(torch.finfo(dtype).eps))
    return float(np.sqrt(np.finfo(np.dtype(dtype)).eps))


def arnoldi_expand(op, Vt, H, invariant_tol=None, *, start_dim=0, max_dim=None,
                   ortho="cgs_dgks"):
    """Extend the Arnoldi factorization ``(Vt, H)`` of ``op`` in place.

    Rows ``0..start_dim`` of ``Vt`` are valid (row ``start_dim`` is the next
    unit start vector) and columns ``0..start_dim - 1`` of ``H``.  Each step
    ``j`` writes column ``j`` of ``H`` (the projection coefficients in rows
    ``0..j``, the coupling ``beta`` in row ``j + 1``, zeros below) and row
    ``j + 1`` of ``Vt``.  On breakdown (``beta < invariant_tol``) the loop
    stops with ``H[j+1, j] = 0`` and the raw orthogonalized vector in
    ``Vt[j+1]``, the contract of the JAX version's masked loop.

    Returns ``(Vt, H, n_iter)``; ``n_iter < max_dim`` iff the expansion hit
    an invariant subspace (happy breakdown).
    """
    m = Vt.shape[0] - 1
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError("A is expected to be a square operator")
    if Vt.shape != (m + 1, n) or H.shape != (m + 1, m):
        raise ValueError(f"Vt {tuple(Vt.shape)} / H {tuple(H.shape)} do not "
                         f"fit an (m+1, n) = ({m + 1}, {n}) workspace")
    if op.dtype != Vt.dtype or H.dtype != Vt.dtype:
        raise TypeError(f"operator {op.dtype}, Vt {Vt.dtype}, H {H.dtype}: "
                        "one dtype expected")
    max_dim = m if max_dim is None else int(max_dim)
    if not 0 <= start_dim <= max_dim <= m:
        raise ValueError(f"need 0 <= start_dim <= max_dim <= {m}, got "
                         f"{start_dim}, {max_dim}")
    if invariant_tol is None:
        invariant_tol = default_invariant_tol(op.dtype)
    ortho_fn = resolve_ortho(ortho)

    for j in range(start_dim, max_dim):
        w = op.matvec(Vt[j])
        h, w, beta, breakdown = ortho_fn(Vt, w, j + 1, tol=invariant_tol)
        H[:, j] = h
        if bool(breakdown):
            H[j + 1, j] = 0
            Vt[j + 1] = w
            return Vt, H, j + 1
        H[j + 1, j] = beta
        torch.div(w, beta, out=Vt[j + 1])
    return Vt, H, max_dim


def block_arnoldi_expand(op, Vt, H, invariant_tol, *, start_block, n_blocks, b):
    """Block Arnoldi expansion of ``(Vt, H)`` in place: b vectors per step.

    Counterpart of ``_block_expand_jit`` (its window ``_block_expand_window``).
    Block ``j`` occupies rows ``j*b..(j+1)*b`` of ``Vt: (n_blocks*b + b, n)``;
    on entry the block at ``start_block`` holds orthonormal rows.  Step
    ``j`` applies the operator to block ``j`` (``op.matmat_rows``, the
    b-column kernels, on the rows as they lie), runs :func:`block_cgs2`
    against the ``(j+1)*b`` rows before it, and writes the coefficients into
    column block ``j`` of ``H: (n_blocks*b + b, n_blocks*b)`` with ``R`` in
    rows ``(j+1)*b..(j+2)*b``, and ``Q`` into block ``j + 1`` of ``Vt``.  A
    rank-deficient step (breakdown) writes nothing and ends the loop: one
    host read of the flag per step, where the JAX version runs the
    remaining steps dead.

    Returns ``(Vt, H, n_done_blocks)``; ``n_done_blocks < n_blocks`` iff a
    step broke down.
    """
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError("A is expected to be a square operator")
    rows = n_blocks * b + b
    if Vt.shape != (rows, n) or H.shape != (rows, n_blocks * b):
        raise ValueError(f"Vt {tuple(Vt.shape)} / H {tuple(H.shape)} do not "
                         f"fit {n_blocks} blocks of {b} rows, n = {n}")
    if op.dtype != Vt.dtype or H.dtype != Vt.dtype:
        raise TypeError(f"operator {op.dtype}, Vt {Vt.dtype}, H {H.dtype}: "
                        "one dtype expected")
    if not 0 <= start_block <= n_blocks:
        raise ValueError(f"need 0 <= start_block <= {n_blocks}, got {start_block}")
    for j in range(start_block, n_blocks):
        lo, mid, hi = j * b, (j + 1) * b, (j + 2) * b
        W = op.matmat_rows(Vt[lo:mid])
        C, Q, R, breakdown = block_cgs2(Vt, W, mid, tol=invariant_tol)
        if bool(breakdown):
            return Vt, H, j
        H[:, lo:mid] = C
        H[mid:hi, lo:mid] = R
        Vt[mid:hi] = Q
    return Vt, H, n_blocks
