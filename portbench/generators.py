"""The benchmark's frozen copy of the matrix generators.

``laplace_2d`` and ``laplace_3d`` are copied from
``arnoldi_tpu_torch/matrices.py`` (with ``laplace``, which both build on),
so that a later change to the program cannot change the matrices the
benchmark hands it.  Any other generator is a file of its own,
``matrices/<generator>.py``, whose ``generate(**args, dtype)`` is likewise
a frozen copy.  They return SciPy CSR matrices on the host.
"""

import re
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from .catalog import load


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


#: The generators of this file a configuration file may name (its
#: ``generator`` key); the others are files in :data:`FOLDER`.
GENERATORS = {"laplace_2d": laplace_2d, "laplace_3d": laplace_3d}

#: ``<generator>.py`` files, each exposing ``generate(**args, dtype)``.
FOLDER = Path(__file__).resolve().parent / "matrices"

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def generator(name):
    """The generator ``name``: ``GENERATORS[name]``, else ``generate`` of
    ``matrices/<name>.py``."""
    if name in GENERATORS:
        return GENERATORS[name]
    path = FOLDER / f"{name}.py"
    if not _NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"unknown generator {name!r}; known: {sorted(GENERATORS)} "
                         f"and {sorted(p.stem for p in FOLDER.glob('*.py'))}")
    return load(path, "portbench_matrices_" + name.replace(".", "_").replace("-", "_")).generate


def build(config):
    """The configuration's matrix: its ``generator`` called with
    ``config["args"]`` and the configuration's dtype."""
    return generator(config["generator"])(**config["args"], dtype=np.dtype(config["dtype"]))
