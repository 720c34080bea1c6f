#!/usr/bin/env python3
"""Phases 32-34 of ``chip_smoke.py`` alone on one NVIDIA card: the filtered
window on laplace_3d(64), the refined float32 filter on laplace_3d(48) as
ELL and the explicit-restart drivers on the scattered 2^20-row matrix,
then the b-column kernels at the filter's widths against their plain
versions (timed beside their bound and cuSPARSE's SpMM) and one sweep
under the profiler.

    python3 scripts/filtered_smoke.py

ARPACK's ten largest-real values of the scattered matrix (computed here on
the host) stand for solve B's and solve Z's references.  Prints the same
lines as those phases of ``chip_smoke.py`` and, last, a JSON object of
their summary fields.  Exits nonzero without a card or when a check fails.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


class _Ready:
    """A reference already computed, in the shape ``chip_smoke.reference``
    reads (an object whose ``get()`` returns ``(values, seconds)``)."""

    def __init__(self, values, seconds):
        self.values, self.seconds = values, seconds

    def get(self):
        return self.values, self.seconds


def main():
    import numpy as np
    import torch
    from scipy.sparse.linalg import eigs

    import chip_smoke as cs
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this run needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.environ["ARNOLDI_PHASES"] = "1"
    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build()
    print(f"built in {time.perf_counter() - t0:.2f} s")
    mats = {"laplace3d64": matrices.laplace_3d(64),
            "laplace3d48": matrices.laplace_3d(48),
            "scattered": cs.scattered_matrix(2**20)}
    t0 = time.perf_counter()
    top = eigs(mats["scattered"], 10, which="LR", tol=1e-8, ncv=40,
               return_eigenvectors=False)
    top = top[np.argsort(-top.real)]
    seconds = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, extra, widths = cs.phase_filtered(mats, {"Z": _Ready(top, seconds)},
                                         kernels.dtype_launch_counts,
                                         {"B": top[:5]})
    print(f"phases 32-34 wall {time.perf_counter() - t0:.2f} s; launches "
          f"{kernels.dtype_launch_counts()}")
    cs.phase_filter_kernels(mats, widths,
                            torch.Generator(device="cuda").manual_seed(4))
    extra["32"]["sweep"] = cs.filter_sweep_split(mats, widths["geometry"])
    print(json.dumps(extra, default=str))


if __name__ == "__main__":
    main()
