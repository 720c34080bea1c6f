"""The port's ``svds`` against the JAX package's and against LAPACK, on
the cases of ``tests/test_svd_generalized.py::TestSvds`` that do not use
``sigma``.

Both packages get the same matrix and the same start vector.  The port's
Gram runs a materialized adjoint leg (``gram_companions``), JAX's float64
Gram a scatter-add adjoint, so the two agree on values, not on bits.
Tolerances are the JAX tests': singular values within ``rtol`` of LAPACK's
and of JAX's, ``A v = s u`` within ``atol``, U and V orthonormal within
1e-8.  The float32 case continues in float64 on the float64 legs, so it
meets the float64 cases' 1e-9 where JAX's double-word target meets 1e-7.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arnoldi_tpu import svds as jax_svds
from arnoldi_tpu.linop import BsrOperator as JaxBsrOperator
from arnoldi_tpu.matrices import laplace
from arnoldi_tpu_torch import BsrOperator, as_operator, svds
from arnoldi_tpu_torch.solvers.svd import gram_companions
from torch_parity import to_numpy

torch.set_num_threads(1)


def _gaussian(shape, seed, shift=0.0):
    A = np.random.default_rng(seed).standard_normal(shape)
    return A + shift * np.eye(*shape)


def _bsr_pair():
    S = sp.random(48, 30, density=0.2,
                  random_state=np.random.RandomState(6)).tocsr()
    return (S, JaxBsrOperator.from_scipy(S, blocksize=(8, 8)),
            BsrOperator.from_scipy(S, blocksize=(8, 8), device="cpu"))


# name: (matrix source, k, svds keywords, rtol of s, atol of A v = s u)
CASES = {
    "dense_rectangular": (lambda: _gaussian((60, 40), 0), 5, {}, 1e-9, 1e-8),
    "sparse_square": (lambda: laplace(100).tocsr(), 3, {}, 1e-8, 1e-8),
    "block": (lambda: _gaussian((50, 30), 3), 4, dict(block_size=2), 1e-8,
              1e-8),
    "wide_internal_transpose": (lambda: _gaussian((20, 35), 4), 4, {}, 1e-9,
                                1e-8),
    "smallest": (lambda: _gaussian((40, 25), 5, shift=3.0), 3,
                 dict(which="SM", ncv=20, maxiter=8000), 1e-7, 1e-7),
    "bsr_adjoint": (_bsr_pair, 3, {}, 1e-8, 1e-8),
    "float32_refined": (lambda: _gaussian((80, 50), 9), 4,
                        dict(tol=1e-9, dtype=np.float32), 1e-9, 1e-8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_svds_matches_jax_and_lapack(case):
    gen, k, kw, rtol, atol = CASES[case]
    src = gen()
    A, jA, pA = src if isinstance(src, tuple) else (src, src, src)
    kw = dict(dict(tol=1e-10, maxiter=3000), **kw)
    v0 = np.random.default_rng(1).standard_normal(min(A.shape))
    U, s, Vh = svds(pA, k, v0=v0, device="cpu", **kw)
    _, sj, _ = jax_svds(jA, k, v0=v0, **kw)
    dense = A.toarray() if sp.issparse(A) else A
    ref = np.linalg.svd(dense, compute_uv=False)
    ref = ref[:k][::-1] if kw.get("which", "LM") == "LM" else np.sort(ref)[:k]
    assert np.all(np.diff(s) >= 0)                  # scipy's ascending order
    np.testing.assert_allclose(s, ref, rtol=rtol)
    np.testing.assert_allclose(s, np.asarray(sj), rtol=max(rtol, 1e-7))
    U, Vh = to_numpy(U), to_numpy(Vh)
    assert U.shape == (A.shape[0], k) and Vh.shape == (k, A.shape[1])
    assert U.dtype == Vh.dtype == np.float64
    np.testing.assert_allclose(dense @ Vh.T, U * s, atol=atol)
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-8)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(k), atol=1e-8)


def test_values_only_and_history():
    A = _gaussian((60, 40), 0)
    s, hist = svds(A, 3, tol=1e-10, return_singular_vectors=False,
                   return_history=True, device="cpu")
    np.testing.assert_allclose(s, np.linalg.svd(A, compute_uv=False)[:3][::-1],
                               rtol=1e-9)
    assert hist.total_matvecs > 0


def test_float32_default_tol_stops_at_the_float32_floor():
    # As JAX's svds builds its operator in float32: tol = sqrt(eps(float32)),
    # no refinement, float32 vectors.
    A = _gaussian((60, 40), 0)
    U, s, Vh = svds(A, 3, dtype=np.float32, device="cpu")
    assert U.dtype == Vh.dtype == torch.float32
    np.testing.assert_allclose(s, np.linalg.svd(A, compute_uv=False)[:3][::-1],
                               rtol=1e-3)


def test_gram_companions():
    A = sp.random(40, 90, density=0.2, random_state=3, format="csr")
    op = as_operator(A, dtype=np.float32, device="cpu")
    (opT,) = gram_companions(A, op)
    assert opT.shape == (90, 40) and opT.dtype == torch.float32
    assert gram_companions(op, op) is None          # no host source
    # a hub column of A is a hub row of A^H: no padded layout, a warning
    n = 5000
    H = sp.csr_matrix((np.ones(n), (np.arange(n), np.zeros(n, int))),
                      shape=(n, n)) + sp.eye(n, format="csr")
    with pytest.warns(RuntimeWarning, match="adjoint"):
        assert gram_companions(H, as_operator(H, device="cpu")) is None


@pytest.mark.parametrize("kwargs,error", [
    (dict(which="XX"), ValueError),
    (dict(sigma=1.0), NotImplementedError),
    (dict(v0=np.ones(7)), ValueError),
], ids=["which", "sigma", "v0"])
def test_bad_arguments_raise(kwargs, error):
    with pytest.raises(error, match="which|ROADMAP|v0"):
        svds(_gaussian((20, 20), 4), 2, device="cpu", **kwargs)
