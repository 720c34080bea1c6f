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
