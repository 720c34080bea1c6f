"""The port's spectrum slicing (``eigsh_window``) against the JAX
package's, on the CPU: from the same bounds and census probes the slices
must be cut where JAX cuts them, and every pair of the window found with
JAX's values; on a 3-D Laplacian (multiple eigenvalues: values, not
counts) and in float32 refined in float64, against the analytic spectra;
and an empty window returns nothing, as JAX's does."""

import jax
import numpy as np
import pytest
import torch

from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace, laplace_3d, laplace_3d_eigen, laplace_eigen
from arnoldi_tpu.solvers import filtered as jf
from arnoldi_tpu_torch import eigsh_window
from arnoldi_tpu_torch.solvers import filtered as pf
from torch_parity import to_numpy

torch.set_num_threads(1)


def _residual(A, vals, vecs):
    V = to_numpy(vecs)
    return np.linalg.norm(A @ V - V * np.asarray(vals)[None, :], axis=0)


def _recording(monkeypatch, module, seen):
    """Record each slice that ``module.eigsh_window`` hands to its
    ``eigsh_filtered``."""
    inner = module.eigsh_filtered

    def slice_solve(A, nev, interval, **kw):
        out = inner(A, nev, interval, **kw)
        seen.append((interval, len(out[0])))
        return out

    monkeypatch.setattr(module, "eigsh_filtered", slice_solve)


def test_window_cuts_and_values_match_jax(monkeypatch):
    n = 400
    L = laplace(n).tocsr()
    a, b = -2.6, -1.4
    key = jax.random.key(0)
    kb, kz, _ = jax.random.split(key, 3)
    bounds = jf.spectrum_bounds(jax_as_operator(L, dtype=np.float64), 40,
                                key=kb)
    census = np.asarray(jax.random.rademacher(kz, (8, n), dtype=np.float64))
    seen_j, seen_p = [], []
    _recording(monkeypatch, jf, seen_j)
    _recording(monkeypatch, pf, seen_p)
    vj, _, _ = jf.eigsh_window(L, (a, b), tol=1e-10, dtype=np.float64, key=key)
    vals, vecs, hist = eigsh_window(L, (a, b), tol=1e-10, dtype=np.float64,
                                    bounds=bounds, device="cpu",
                                    _probes={"census": census})
    assert len(seen_p) == len(seen_j) >= 2
    np.testing.assert_allclose([iv for iv, _ in seen_p],
                               [iv for iv, _ in seen_j], rtol=1e-12)
    full = np.sort(laplace_eigen(n))
    want = full[(full >= a) & (full <= b)]
    assert len(vals) == len(vj) == want.size == 78
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vals, want, atol=1e-9)
    assert _residual(L, vals, vecs).max() < 1e-9
    V = to_numpy(vecs)
    np.testing.assert_allclose(V.T @ V, np.eye(want.size), atol=1e-10)
    assert hist.total_matvecs > 0 and hist.matvecs.shape == (want.size,)


def test_window_3d_laplacian():
    L = laplace_3d(16)
    full = np.sort(laplace_3d_eigen(16))
    a, b = -11.0, -10.7
    want = full[(full >= a) & (full <= b)]
    assert want.size > 5
    vals, vecs, _ = eigsh_window(L, (a, b), tol=1e-10, dtype=np.float64,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(6))
    assert len(vals) == want.size
    np.testing.assert_allclose(vals, want, atol=1e-9)
    assert _residual(L, vals, vecs).max() < 1e-9 * 12


def test_window_empty():
    L = laplace(100).tocsr()       # its smallest eigenvalue is -3.999033
    kw = dict(bounds=(-4.05, 0.05), tol=1e-9, dtype=np.float64)
    vj, Vj, _ = jf.eigsh_window(L, (-4.04, -3.9995), key=jax.random.key(2),
                                **kw)
    vals, vecs, hist = eigsh_window(L, (-4.04, -3.9995), device="cpu", **kw)
    assert len(vals) == len(vj) == 0
    assert tuple(vecs.shape) == np.shape(Vj) == (100, 0)
    assert hist.total_matvecs > 0


def test_window_f32_refined():
    n = 200
    L = laplace(n).tocsr()
    a, b = -2.15, -1.95
    full = np.sort(laplace_eigen(n))
    want = full[(full >= a) & (full <= b)]
    vals, vecs, _ = eigsh_window(L, (a, b), tol=1e-9, dtype=np.float32,
                                 device="cpu")
    assert vecs.dtype == torch.float64
    assert len(vals) == want.size
    np.testing.assert_allclose(vals, want, atol=1e-8)
    assert _residual(L, vals, vecs).max() < 4 * 1e-8


def test_window_bad_arguments_raise():
    L = laplace(50).tocsr()
    with pytest.raises(ValueError, match="empty interval"):
        eigsh_window(L, (-1.0, -2.0), device="cpu")
    with pytest.raises(ValueError, match="outside the spectral enclosure"):
        eigsh_window(L, (10.0, 12.0), dtype=np.float64, device="cpu")
