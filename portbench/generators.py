"""The benchmark's frozen copy of the matrix generators.

``laplace_2d`` and ``laplace_3d`` are copied from
``arnoldi_tpu_torch/matrices.py`` (with ``laplace``, which both build on),
so that a later change to the program cannot change the matrices the
benchmark hands it.  They return SciPy CSR matrices on the host.
"""

import numpy as np
import scipy.sparse as sp


def laplace(n, dtype=None):
    """1-D Laplacian: tridiagonal with -2 on the diagonal, 1 off-diagonal."""
    off = np.ones(n - 1, dtype=dtype)
    main = -2 * np.ones(n, dtype=dtype)
    return sp.diags_array([main, off, off], offsets=[0, -1, 1])


def laplace_2d(nx, ny=None, dtype=None):
    """2-D five-point Laplacian on an ``nx x ny`` grid (Dirichlet)."""
    ny = ny or nx
    lx = laplace(nx, dtype=dtype)
    ly = laplace(ny, dtype=dtype)
    return (sp.kron(sp.eye_array(ny), lx) + sp.kron(ly, sp.eye_array(nx))).tocsr()


def laplace_3d(nx, ny=None, nz=None, dtype=None):
    """3-D seven-point Laplacian on an ``nx x ny x nz`` grid (Dirichlet)."""
    ny = ny or nx
    nz = nz or nx
    Ix, Iy, Iz = (sp.eye_array(m) for m in (nx, ny, nz))
    lx, ly, lz = (laplace(m, dtype=dtype) for m in (nx, ny, nz))
    return (sp.kron(Iz, sp.kron(Iy, lx))
            + sp.kron(Iz, sp.kron(ly, Ix))
            + sp.kron(lz, sp.kron(Iy, Ix))).tocsr()


#: The generators a configuration file may name (its ``generator`` key).
GENERATORS = {"laplace_2d": laplace_2d, "laplace_3d": laplace_3d}


def build(config):
    """The configuration's matrix: ``GENERATORS[config["generator"]]``
    called with ``config["args"]`` and the configuration's dtype."""
    try:
        gen = GENERATORS[config["generator"]]
    except KeyError:
        raise ValueError(f"unknown generator {config['generator']!r}; "
                         f"known: {sorted(GENERATORS)}") from None
    return gen(**config["args"], dtype=np.dtype(config["dtype"]))
