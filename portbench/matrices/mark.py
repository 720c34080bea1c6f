"""``mark``: the Markov random walk of Saad, NMLEP 2nd ed. §2.5.1 (the
Matrix Market NEP collection's MARKOV family), non-symmetric with a real
spectrum.

A frozen copy of ``mark`` in ``arnoldi_tpu_torch/matrices.py``, so that a
later change to the program cannot change the matrix the benchmark hands
it.  A configuration names it as ``"generator": "mark"`` with ``"args":
{"m": ...}``: n = m (m + 1) / 2, at most 4 nonzeros a row.
"""

import numpy as np
import scipy.sparse as sp


def mark(m, dtype=np.float64):
    """Markov random-walk transition matrix on a triangular grid with ``m`` rows.

    ``n = m*(m+1)/2`` states ``(i, j)`` with ``0 <= i < m``, ``0 <= j < m-i``,
    enumerated row-major.  From state ``(i, j)`` the walk moves

    * north ``(i, j+1)`` and east ``(i+1, j)`` with weight
      ``pd = 0.5*(i+j+1)/(m-1)`` — doubled on the ``i == 0`` (north) and
      ``j == 0`` (east) boundaries (reflection),
    * south ``(i, j-1)`` and west ``(i-1, j)`` with weight
      ``pu = 0.5 - 0.5*(i+j-1)/(m-1)`` where those neighbours exist.

    This is the example operator of Saad, *Numerical Methods for Large
    Eigenvalue Problems* (2nd ed.) §2.5.1, whose convergence tables 6.1-6.3
    anchor the test suite.  Matches the reference generator
    (``src/arnoldi/matrices.py:5-73``) entry-for-entry.
    """
    if m < 2:
        raise ValueError("mark(m) requires m >= 2")
    n = m * (m + 1) // 2
    cst = 0.5 / (m - 1)

    # State coordinates, row-major: i is the grid row, j the offset inside it.
    i = np.repeat(np.arange(m), np.arange(m, 0, -1))
    j = np.arange(n) - np.repeat(np.cumsum(np.concatenate([[0], np.arange(m, 1, -1)])), np.arange(m, 0, -1))
    ix = np.arange(n)
    jmax = m - i

    pd = cst * (i + j + 1)
    pu = 0.5 - cst * (i + j - 1)

    rows, cols, vals = [], [], []

    interior = j < jmax - 1  # states with north/east moves
    # North: (i, j) -> (i, j+1); doubled on the i == 0 boundary.
    rows.append(ix[interior])
    cols.append(ix[interior] + 1)
    vals.append(pd[interior] * np.where(i[interior] == 0, 2.0, 1.0))
    # East: (i, j) -> (i+1, j); doubled on the j == 0 boundary.
    rows.append(ix[interior])
    cols.append(ix[interior] + jmax[interior])
    vals.append(pd[interior] * np.where(j[interior] == 0, 2.0, 1.0))
    # South: (i, j) -> (i, j-1).
    south = j > 0
    rows.append(ix[south])
    cols.append(ix[south] - 1)
    vals.append(pu[south])
    # West: (i, j) -> (i-1, j).
    west = i > 0
    rows.append(ix[west])
    cols.append(ix[west] - jmax[west] - 1)
    vals.append(pu[west])

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals).astype(dtype)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


generate = mark
