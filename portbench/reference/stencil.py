"""Dirichlet Laplacians on a grid, applied as stencils, with their exact
eigenpairs.

Grid points are numbered with x fastest (``index = (z * ny + y) * nx +
x``), as the Kronecker products of the generators number them.  In one
dimension the Laplacian of size m has the eigenvalues ``-2 + 2 cos(k pi /
(m + 1))`` and the eigenvectors ``sin(j k pi / (m + 1))``, k, j = 1..m; on
a grid they add and multiply.
"""

import numpy as np


class Grid:
    """A Laplacian on an ``nx x ny (x nz)`` grid, from a configuration's
    ``generator`` and ``args``."""

    def __init__(self, generator, args):
        if generator == "laplace_2d":
            nx = int(args["nx"])
            self.shape = (nx, int(args.get("ny") or nx))
        elif generator == "laplace_3d":
            nx = int(args["nx"])
            self.shape = (nx, int(args.get("ny") or nx), int(args.get("nz") or nx))
        else:
            raise ValueError(f"no reference for generator {generator!r}")
        self.n = int(np.prod(self.shape))
        self.itemsize = 8

    @property
    def nnz(self):
        """Stored nonzeros of the matrix: the diagonal and, per axis, two
        neighbours of every point but those on that axis' faces."""
        total = self.n
        for m in self.shape:
            total += 2 * (self.n // m) * (m - 1)
        return total

    def apply(self, V):
        """``A @ V`` for an ``(n, k)`` block, by shifts on the grid."""
        k = V.shape[1]
        G = V.reshape(tuple(reversed(self.shape)) + (k,))
        out = (-2.0 * len(self.shape)) * G
        for axis in range(len(self.shape)):
            lo = [slice(None)] * G.ndim
            hi = [slice(None)] * G.ndim
            lo[axis], hi[axis] = slice(0, -1), slice(1, None)
            out[tuple(lo)] += G[tuple(hi)]
            out[tuple(hi)] += G[tuple(lo)]
        return out.reshape(self.n, k)

    def _modes(self, dtype):
        """Per axis (in x, y, z order): the 1-D eigenvalues, ascending."""
        out = []
        for m in self.shape:
            k = np.arange(1, m + 1, dtype=dtype)
            out.append(dtype(-2) + dtype(2) * np.cos(k * dtype(np.pi) / dtype(m + 1)))
        return out

    def spectrum(self, dtype=np.float64):
        """Every eigenvalue with its mode tuple: ``(values, modes)``, values
        ascending, ``modes[i]`` the 1-based (kx, ky[, kz]) of ``values[i]``."""
        lam = self._modes(dtype)
        grids = np.meshgrid(*[np.arange(1, m + 1) for m in self.shape],
                            indexing="ij")
        vals = sum(l[g - 1] for l, g in zip(lam, grids)).ravel()
        modes = np.stack([g.ravel() for g in grids], axis=1)
        order = np.argsort(vals, kind="stable")
        return vals[order], modes[order]

    def eigenvector(self, mode, dtype=np.float64):
        """The unit eigenvector of a mode tuple, as an ``(n,)`` array."""
        factors = []
        for m, k in zip(self.shape, mode):
            j = np.arange(1, m + 1, dtype=dtype)
            f = np.sin(j * (dtype(k) * dtype(np.pi) / dtype(m + 1)))
            factors.append(f / np.linalg.norm(f))
        v = factors[0]
        for f in factors[1:]:
            v = np.multiply.outer(f, v)       # later axes vary slower
        return v.ravel()
