"""Milliseconds the device idles in one restart's host turn: inside the
program's ``restart`` spans (H to the host, its ordered Schur form or the
device loop's ``eigh``, the truncation enqueued, the flag read; the next
expansion outside), over the restarts, in the traced run's device-only
solve."""

from portbench.program_spans import traced_solve

UNIT = "ms"
LAYER = "Restart drivers"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    solve = traced_solve(run)
    return None if solve is None else solve.idle_per_span_ms("restart")
