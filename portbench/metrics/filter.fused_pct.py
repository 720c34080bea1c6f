"""The share of the filter's sweeps that took the fused route: of the
traced run's device-only solve's ``filter.sweep`` spans that filtered
rows, those that hold a ``filter.fused`` span (each degree step of the
Chebyshev filter one launch, ``ops/kernels/cheby_banded``).  A sweep
filtered rows when its count (column matvecs: the degree times the rows
filtered, plus the Rayleigh-Ritz product's s) passes its slice's s, the
count of the ``filter.start_block`` span before it.  A program without
the fused route reads nothing."""

import importlib.util

from portbench import program_spans
from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Filter"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "higher"
SPANS = {}

_ROUTE = "arnoldi_tpu_torch.ops.kernels.cheby_banded"


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
    sweeps, s = [], None
    for span in solve.spans:          # in the order they opened
        if span.name == "filter.start_block":
            s = span.count
        elif (span.name == "filter.sweep" and s is not None
              and span.count is not None and span.count > s):
            sweeps.append(span)
    if not sweeps:
        return None
    every = program_spans.program_spans()

    def key(span):
        return span.name, span.start_ns, span.end_ns

    def sweep_of(span):
        while span.parent is not None:
            span = every[span.parent]
            if span.name == "filter.sweep":
                return key(span)
        return None

    holders = {sweep_of(span) for span in solve.named(("filter.fused",))}
    return 100.0 * sum(key(span) in holders for span in sweeps) / len(sweeps)
