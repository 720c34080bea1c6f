"""Helpers for the tests that hold ``arnoldi_tpu_torch`` against
``arnoldi_tpu``: carry a JAX operator's arrays over to the port, and compare
Schur decompositions."""

import numpy as np
import torch

from arnoldi_tpu_torch.convert import operator_from_reference


def port_operator(jax_op, device="cpu"):
    """The port's operator built from a JAX operator's own arrays."""
    leaves, aux = jax_op.tree_flatten()
    return operator_from_reference(type(jax_op).__name__,
                                   [np.asarray(x) for x in leaves], aux,
                                   device=device)


def to_numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def schur_residuals(A, Q, T):
    """Column norms of ``A Q - Q T`` for a SciPy/NumPy ``A``."""
    Q, T = to_numpy(Q), to_numpy(T)
    return np.linalg.norm(A @ Q - Q @ T, axis=0)


def assert_quasi_triangular(T):
    """Zero below the subdiagonal, and no two adjacent nonzero subdiagonal
    entries (each nonzero one is a 2x2 block of a conjugate pair)."""
    T = to_numpy(T)
    assert np.array_equal(np.tril(T, -2), np.zeros_like(T))
    sub = np.diag(T, -1) != 0
    assert not np.any(sub[1:] & sub[:-1])
