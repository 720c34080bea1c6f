"""The share of the traced run's device-only solve spent continuing the
filter's float32 slices in float64: the wall of the program's
``refine.filter`` spans (one a refined slice of ``eigsh_filtered``),
their union, over the wall of the program's ``solve``.  None where no
slice was refined, or the program opens no such span."""

from portbench.program_spans import length_ns, traced_solve

UNIT = "%"
LAYER = "Restart drivers"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    solve = traced_solve(run)
    if solve is None:
        return None
    spans = solve.named(("refine.filter",))
    wall = solve.solve.end_ns - solve.solve.start_ns
    if not spans or wall <= 0:
        return None
    return 100.0 * length_ns(solve.union(spans)) / wall
