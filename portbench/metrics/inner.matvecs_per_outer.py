"""Products with the shifted operator an outer shift-invert product costs:
``InnerSolveStats.inner_matvecs`` over ``.solves``, summed over the
window's solves."""

UNIT = "matvecs"
LAYER = "Spectral transform"
MOVES = "solve_s"
SOURCE = "program_counter"
BETTER = "lower"
SPANS = {}


def read(run):
    inner = sum(c.get("inner_matvecs", 0) for c in run.counters)
    solves = sum(c.get("inner_solves", 0) for c in run.counters)
    return inner / solves if solves else None
