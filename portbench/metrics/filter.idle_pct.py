"""The device's idle share inside the filter's sweeps: the program's
``filter.sweep`` (the Chebyshev filter, CholQR2, Rayleigh-Ritz) and
``filter.ghost_gate`` spans (with their pending filter products), their
wall against the device's busy union, in the traced run's device-only
solve.  The start block's draw (``filter.start_block``) is outside."""

from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Filter"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    solve = traced_solve(run)
    return None if solve is None else solve.idle_pct(("filter.sweep",
                                                      "filter.ghost_gate"))
