"""The share of the shift-invert inner solves that took the fused route:
the traced run's device-only solve's ``inner.solve`` spans that hold an
``inner.fused`` span (the whole CG solve in one launch,
``ops/kernels/cg_banded``), over all its ``inner.solve`` spans.  A program
without the fused route reads nothing."""

import importlib.util

from portbench import program_spans
from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Spectral transform"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "higher"
SPANS = {}

_ROUTE = "arnoldi_tpu_torch.ops.kernels.cg_banded"


def _has_route():
    try:
        return importlib.util.find_spec(_ROUTE) is not None
    except ImportError:
        return False


def read(run):
    if not _has_route():
        return None
    solve = traced_solve(run)
    if solve is None:
        return None
    solves = solve.named(("inner.solve",))
    if not solves:
        return None
    every = program_spans.program_spans()

    def key(s):
        return s.name, s.start_ns, s.end_ns

    holders = {key(every[s.parent]) for s in solve.named(("inner.fused",))
               if s.parent is not None}
    return 100.0 * sum(key(s) in holders for s in solves) / len(solves)
