"""Matrix-vector products a solve makes, ``History.total_matvecs`` (a
b-column product counts b; a shift-invert solve counts its outer
products), averaged over the window's solves."""

UNIT = "matvecs"
LAYER = "Restart drivers"
MOVES = "solve_s"
SOURCE = "program_counter"
BETTER = "lower"
SPANS = {}


def read(run):
    counts = [c["matvecs"] for c in run.counters if c.get("matvecs") is not None]
    return sum(counts) / len(counts) if counts else None
