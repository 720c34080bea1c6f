"""Scalar CGS2's share of the HBM roofline: the least bytes of two
classical Gram-Schmidt passes at each call's shapes (``counts.cgs2_bytes``:
the rows read three times), summed, over the device time launched inside
the calls, against the card's peak bandwidth.  Bytes bound it: under three
flops a basis element read is far below the card's float64 rate per byte."""

from portbench.counts import cgs2_bytes

UNIT = "%"
LAYER = "Orthogonalization"
MOVES = "solve_s"
SOURCE = "device_trace"
BETTER = "higher"


def _capture(Vt, w, n_active, **kwargs):
    return cgs2_bytes(w.shape[-1], int(n_active), w.element_size())


SPANS = {"ortho": [("arnoldi_tpu_torch.ops.ortho:ORTHO_KERNELS[cgs2]", _capture)]}


def read(run):
    return run.roofline("ortho", sum(run.calls.get("ortho", [])))
