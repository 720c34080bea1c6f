"""The share of the device's idle time in the traced run's device-only
solve that falls in no program span below ``solve``: what the program's
spans cannot place (the measurement's blind spot)."""

from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Device"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    solve = traced_solve(run)
    return None if solve is None else solve.unspanned_idle_pct()
