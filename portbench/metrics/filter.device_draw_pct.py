"""The share of the start blocks whose Gaussian rows were drawn on the
card: of the traced run's device-only solve's ``filter.start_block`` spans
that drew rows, those that hold a ``filter.device_draw`` span with a count
above 0 (the rows drawn there, from a card generator seeded by one draw
of the host's).  A start block whose ``filter.device_draw`` counts 0 rows
carried all its rows in and drew none; one without the span drew on the
host.  A program without the card draw reads nothing."""

import importlib

from portbench import program_spans
from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Filter"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "higher"
SPANS = {}

_ROUTE = ("arnoldi_tpu_torch.solvers.filtered", "_card_rows")


def _has_route():
    module, name = _ROUTE
    try:
        return hasattr(importlib.import_module(module), name)
    except ImportError:
        return False


def read(run):
    if not _has_route():
        return None
    solve = traced_solve(run)
    if solve is None:
        return None
    every = program_spans.program_spans()

    def key(span):
        return span.name, span.start_ns, span.end_ns

    drawn = {}                 # start block -> rows drawn on the card
    for span in solve.named(("filter.device_draw",)):
        if span.parent is not None:
            drawn[key(every[span.parent])] = span.count or 0
    blocks = [key(span) for span in solve.named(("filter.start_block",))]
    drew = [b for b in blocks if drawn.get(b) != 0]
    if not drew:
        return None
    return 100.0 * sum(drawn.get(b, 0) > 0 for b in drew) / len(drew)
