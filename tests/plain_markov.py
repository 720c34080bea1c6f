"""A plain PyTorch reference for the Markov random walk ``mark(m)``.

Only ``torch`` and ``math``: nothing of the port, the benchmark or JAX.
The matrix is built state by state from Saad's formula (*Numerical
Methods for Large Eigenvalue Problems*, 2nd ed., §2.5.1), applied with
``torch.sparse.mm`` and diagonalized densely with ``torch.linalg.eig``, so
a test can hold the port's operator and solvers to it.
"""

import math

import torch


def mark(m):
    """The transition matrix of the random walk on a triangular grid of
    ``m`` rows, as a float64 ``torch.sparse_csr_tensor``.

    The states ``(i, j)``, ``0 <= i < m``, ``0 <= j < m - i``, are numbered
    row by row.  From ``(i, j)`` the walk moves north to ``(i, j + 1)`` and
    east to ``(i + 1, j)`` with ``pd = (i + j + 1) / (2 (m - 1))``, the
    north move doubled on ``i = 0`` and the east move on ``j = 0``, and
    south to ``(i, j - 1)`` and west to ``(i - 1, j)``, where they exist,
    with ``pu = 1/2 - (i + j - 1) / (2 (m - 1))``.
    """
    if m < 2:
        raise ValueError("mark(m) needs m >= 2")
    index = {}
    for i in range(m):
        for j in range(m - i):
            index[(i, j)] = len(index)
    n = len(index)
    assert n == m * (m + 1) // 2
    cst = 0.5 / (m - 1)
    entries = {}
    for (i, j), k in index.items():
        pd = cst * (i + j + 1)
        pu = 0.5 - cst * (i + j - 1)
        if (i, j + 1) in index:
            entries[(k, index[(i, j + 1)])] = pd * (2.0 if i == 0 else 1.0)
            entries[(k, index[(i + 1, j)])] = pd * (2.0 if j == 0 else 1.0)
        if j > 0:
            entries[(k, index[(i, j - 1)])] = pu
        if i > 0:
            entries[(k, index[(i - 1, j)])] = pu
    keys = sorted(entries)
    crow = [0] * (n + 1)
    for r, _ in keys:
        crow[r + 1] += 1
    for r in range(n):
        crow[r + 1] += crow[r]
    return torch.sparse_csr_tensor(
        torch.tensor(crow, dtype=torch.int64),
        torch.tensor([c for _, c in keys], dtype=torch.int64),
        torch.tensor([entries[key] for key in keys], dtype=torch.float64),
        size=(n, n))


def apply(A, V):
    """``A @ V`` for a sparse ``A`` and a dense vector or ``(n, k)`` block."""
    if V.ndim == 1:
        return torch.sparse.mm(A, V[:, None])[:, 0]
    return torch.sparse.mm(A, V)


def eig_dense(A):
    """Every eigenvalue of ``A`` (complex128), by ``torch.linalg.eig`` on the
    dense matrix."""
    D = A.to_dense() if A.layout != torch.strided else A
    return torch.linalg.eigvals(D.to(torch.float64))


def radius(values):
    """The spectral radius of a set of eigenvalues."""
    return max(abs(complex(v)) for v in values.tolist())


def schur_numbers(A, Q, T, values):
    """How far a partial Schur form ``A Q ~= Q T`` is from ``A``'s spectrum
    ``values`` (all of them, complex): ``(value_err, residual, orth)``, the
    first two over the spectral radius.  ``value_err`` is the largest
    distance of an eigenvalue of ``T`` from its nearest one in ``values``;
    ``residual`` the largest column norm of ``A Q - Q T``; ``orth`` the
    largest entry of ``|Q^T Q - I|``."""
    Q = Q.to(torch.float64)
    T = T.to(torch.float64)
    rad = radius(values)
    lam = torch.linalg.eigvals(T)
    value_err = max(float(torch.abs(values - mu).min()) for mu in lam.tolist())
    R = apply(A, Q) - Q @ T
    residual = float(torch.linalg.vector_norm(R, dim=0).max())
    orth = float(torch.abs(Q.T @ Q - torch.eye(Q.shape[1], dtype=Q.dtype)).max())
    return value_err / rad, residual / rad, orth


def wanted_lr(values, k):
    """The ``k`` eigenvalues of largest real part, a conjugate pair cut at
    ``k`` kept whole (``k + 1``), most wanted first."""
    order = sorted(values.tolist(), key=lambda v: -v.real)
    if k < len(order) and math.isclose(order[k - 1].real, order[k].real) \
            and order[k - 1].imag != 0:
        k += 1
    return order[:k]
