"""Helpers for the tests that hold ``arnoldi_tpu_torch`` against
``arnoldi_tpu``: carry a JAX operator's arrays over to the port, compare
Schur decompositions, count a refined solve's float64 continuation, and
the ``cuda_device`` fixture of the tests marked ``cuda``."""

import numpy as np
import pytest
import torch

from arnoldi_tpu_torch.convert import operator_from_reference


def reference_leaves(jax_op):
    """``(kind, leaves, aux)`` of a JAX operator as ``convert`` takes them:
    array leaves as NumPy arrays, a Gram's operator legs (or None) as
    ``(kind, leaves, aux)`` in turn."""
    leaves, aux = jax_op.tree_flatten()
    kind = type(jax_op).__name__
    if kind == "GramOperator":
        leaves = [None if leg is None else reference_leaves(leg)
                  for leg in leaves]
    else:
        leaves = [np.asarray(x) for x in leaves]
    return kind, leaves, aux


def port_operator(jax_op, device="cpu"):
    """The port's operator built from a JAX operator's own arrays."""
    return operator_from_reference(*reference_leaves(jax_op), device=device)


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


def jax_start_block(n, b, v0, dtype=np.float64):
    """The JAX package's block start block when it is given ``v0`` (and no
    ``key``): v0 normalized and b - 1 rows of ``normal(key(0))``
    (``krylov_schur.py:421-422``), for the port's ``_start_block``."""
    import jax

    v0 = np.asarray(v0, dtype) / np.linalg.norm(v0)
    extra = np.asarray(jax.random.normal(jax.random.key(0), (b - 1, n),
                                         dtype=dtype))
    return np.vstack([v0[None, :], extra])


class ContinuationCounter:
    """Records the matvecs of each float64 continuation that
    ``arnoldi_tpu_torch.solvers.refine.refine_schur`` runs while installed
    with ``monkeypatch.setattr(refine, "refine_schur", counter)``."""

    def __init__(self, refine_schur):
        self.inner = refine_schur
        self.matvecs = []

    def __call__(self, *args, **kwargs):
        out = self.inner(*args, **kwargs)
        self.matvecs.append(out[3])
        return out


@pytest.fixture
def cuda_device():
    """The card, for a test marked ``cuda``: it skips (a skip counts no
    pass) where ``torch.cuda.is_available()`` is false, decided when the
    test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")
