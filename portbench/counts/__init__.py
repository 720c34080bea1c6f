"""The least bytes an operation moves, from its shapes.

Each function counts what the operation itself needs (each input byte
read once, each output byte written once, a sparse matrix by its stored
nonzeros), not what a given kernel moves, so any implementation of the
operation is held to the same count and a faster one reads closer to 100 %
of the bound, never past it.  A roofline share divides the count by the
device time and the peak bandwidth of :mod:`portbench.peaks`.
"""


def cgs2_bytes(n, j, itemsize):
    """Classical Gram-Schmidt with two passes of ``w`` (n entries) against
    ``j`` basis rows.  Each pass needs every coefficient of its projection
    before its update, but the first pass's update and the second's
    projection can share one sweep over the rows: the rows are read three
    times.  ``w`` is read once and the result written once (``w`` is far
    smaller than the rows, and its rereads can come from the L2)."""
    return (3 * j * n + 2 * n) * itemsize


def spmv_bytes(nnz, n, b, itemsize):
    """A sparse matrix of ``nnz`` stored values times ``b`` vectors of n
    entries: the values once, x and y once each (indices not counted)."""
    return (nnz + 2 * n * b) * itemsize


def cheby_filter_bytes(nnz, n, s, degree, itemsize):
    """The Chebyshev recurrence of ``degree`` steps on ``s`` vectors of n
    entries, ``T_{j+1} = 2 (A T_j - c T_j) / e - T_{j-1}``, ``Y += c_{j+1}
    T_{j+1}``.  The first step reads the matrix and ``T_0 = X`` and writes
    ``T_1`` and ``Y``; each later step reads the matrix, ``T_j`` and
    ``T_{j-1}``, writes ``T_{j+1}`` and reads and writes ``Y``."""
    if degree < 1:
        return 2 * n * s * itemsize
    block = n * s * itemsize
    return degree * nnz * itemsize + 3 * block + (degree - 1) * 5 * block
