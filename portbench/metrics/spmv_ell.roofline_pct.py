"""The ELL SpMV's share of the HBM roofline: the matrix's stored nonzeros,
x and y once a call (``counts.spmv_bytes``, b columns at a time), over
the device time launched inside the ELL operator's products, against the
card's peak bandwidth.  Reported in the mark(1000) cell, whose values, x
and y (24 MB) fit the 50 MB L2 only with nothing else in it: between two
products up to 40 basis rows of 4 MB each stream through it, so the
matrix comes from HBM again.  A reading near 100 % would say the L2 served
it, and the share would no longer be one of HBM bandwidth."""

from portbench.counts import spmv_bytes

UNIT = "%"
LAYER = "Operator / SpMV"
MOVES = "solve_s"
SOURCE = "device_trace"
BETTER = "higher"


def _capture(op, x):
    return (op.shape[0], 1 if x.ndim == 1 else x.shape[0], x.element_size())


SPANS = {"spmv_ell": [("arnoldi_tpu_torch.linop:EllOperator.matvec", _capture),
                      ("arnoldi_tpu_torch.linop:EllOperator.matmat_rows", _capture)]}


def read(run):
    nnz = run.matrix["nnz"]
    total = sum(spmv_bytes(nnz, n, b, itemsize)
                for n, b, itemsize in run.calls.get("spmv_ell", []))
    return run.roofline("spmv_ell", total)
