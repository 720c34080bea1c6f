"""The Chebyshev filter's share of the HBM roofline: the least bytes of its
recurrence at each call's block and degree (``counts.cheby_filter_bytes``:
per degree step the matrix once, T_j and T_{j-1} read, T_{j+1} written,
the accumulator read and written), over the device time launched inside
``cheby_filter``, against the card's peak bandwidth.  Bytes bound it."""

from portbench.counts import cheby_filter_bytes

UNIT = "%"
LAYER = "Filter"
MOVES = "solve_s"
SOURCE = "device_trace"
BETTER = "higher"


def _capture(op, X, coeffs, lmin, lmax):
    return (X.shape[1], X.shape[0], len(coeffs) - 1, X.element_size())


SPANS = {"filter": [("arnoldi_tpu_torch.solvers.filtered:cheby_filter", _capture)]}


def read(run):
    nnz = run.matrix["nnz"]
    total = sum(cheby_filter_bytes(nnz, n, s, degree, itemsize)
                for n, s, degree, itemsize in run.calls.get("filter", []))
    return run.roofline("filter", total)
