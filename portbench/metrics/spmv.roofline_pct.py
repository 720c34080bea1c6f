"""The DIA SpMV's share of the HBM roofline: the matrix's stored nonzeros,
x and y once a call (``counts.spmv_bytes``, b columns at a time), over
the device time launched inside the operator's products, against the
card's peak bandwidth.  Reported where the working set passes the 50 MB
L2 (the 3-D window's b-column products): a 2-D cell's bands, x and y fit
it, and a share of HBM bandwidth there could read above 100 %."""

from portbench.counts import spmv_bytes

UNIT = "%"
LAYER = "Operator / SpMV"
MOVES = "solve_s"
SOURCE = "device_trace"
BETTER = "higher"


def _capture(op, x):
    return (op.shape[0], 1 if x.ndim == 1 else x.shape[0], x.element_size())


SPANS = {"spmv": [("arnoldi_tpu_torch.linop:BandedOperator.matvec", _capture),
                  ("arnoldi_tpu_torch.linop:BandedOperator.matmat_rows", _capture)]}


def read(run):
    nnz = run.matrix["nnz"]
    total = sum(spmv_bytes(nnz, n, b, itemsize)
                for n, b, itemsize in run.calls.get("spmv", []))
    return run.roofline("spmv", total)
