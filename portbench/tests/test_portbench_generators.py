"""The frozen generators give the program's matrices, and the reference's
stencil and closed-form spectrum are those matrices'."""

import numpy as np
import pytest

from arnoldi_tpu_torch import matrices
from portbench import generators
from portbench.reference.stencil import Grid


@pytest.mark.parametrize("nx, ny", [(5, None), (7, 4), (30, None)])
def test_laplace_2d_matches_the_program(nx, ny):
    a = generators.laplace_2d(nx, ny, dtype=np.float64)
    b = matrices.laplace_2d(nx, ny, dtype=np.float64)
    assert (a != b).nnz == 0 and a.shape == b.shape and a.nnz == b.nnz


@pytest.mark.parametrize("dims", [(4, None, None), (5, 3, 2), (12, None, None)])
def test_laplace_3d_matches_the_program(dims):
    a = generators.laplace_3d(*dims, dtype=np.float64)
    b = matrices.laplace_3d(*dims, dtype=np.float64)
    assert (a != b).nnz == 0 and a.shape == b.shape and a.nnz == b.nnz


@pytest.mark.parametrize("gen, args", [("laplace_2d", {"nx": 9, "ny": 6}),
                                       ("laplace_3d", {"nx": 5, "ny": 4, "nz": 3})])
def test_stencil_and_spectrum(gen, args):
    A = generators.GENERATORS[gen](**args, dtype=np.float64)
    grid = Grid(gen, args)
    V = np.random.default_rng(0).standard_normal((grid.n, 3))
    np.testing.assert_allclose(grid.apply(V), A @ V, atol=1e-13)
    assert grid.nnz == A.nnz
    vals, modes = grid.spectrum()
    np.testing.assert_allclose(vals, np.linalg.eigvalsh(A.toarray()), atol=1e-12)
    for i in (0, len(vals) // 2, len(vals) - 1):
        v = grid.eigenvector(modes[i])
        np.testing.assert_allclose(A @ v, vals[i] * v, atol=1e-12)
        assert abs(np.linalg.norm(v) - 1) < 1e-14


def _mark_loop(m):
    """``mark(m)`` state by state, as arnoldi-py's generator builds it:
    from (i, j), north and east with ``pd`` (doubled on the i = 0 and j = 0
    edges), south and west with ``pu``."""
    index = {}
    for i in range(m):
        for j in range(m - i):
            index[i, j] = len(index)
    cst = 0.5 / (m - 1)
    A = np.zeros((len(index), len(index)))
    for (i, j), ix in index.items():
        pd, pu = cst * (i + j + 1), 0.5 - cst * (i + j - 1)
        if j < m - i - 1:
            A[ix, index[i, j + 1]] = pd * (2.0 if i == 0 else 1.0)
            A[ix, index[i + 1, j]] = pd * (2.0 if j == 0 else 1.0)
        if j > 0:
            A[ix, index[i, j - 1]] = pu
        if i > 0:
            A[ix, index[i - 1, j]] = pu
    return A


@pytest.mark.parametrize("m", [2, 3, 10, 100])
def test_mark_matches_the_program_and_the_reference(m):
    a = generators.build({"generator": "mark", "args": {"m": m}, "dtype": "float64"})
    b = matrices.mark(m)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.shape == b.shape
    if m <= 10:
        np.testing.assert_array_equal(a.toarray(), _mark_loop(m))
    if m == 2:       # arnoldi-py's golden matrix
        np.testing.assert_array_equal(a.toarray(), [[0, 1, 1], [0.5, 0, 0], [0.5, 0, 0]])


def test_mark_1000_is_the_deployment_size():
    a = generators.build({"generator": "mark", "args": {"m": 1000}, "dtype": "float64"})
    assert a.shape == (500_500, 500_500) and a.nnz == 1_998_000
    assert np.diff(a.indptr).max() <= 4


@pytest.mark.parametrize("name", ["no_such_generator", "../generators", "mark/x"])
def test_an_unknown_generator_is_refused(name):
    with pytest.raises(ValueError, match="unknown generator"):
        generators.generator(name)
