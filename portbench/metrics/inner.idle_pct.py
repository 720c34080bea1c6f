"""The device's idle share inside the shift-invert inner solves: the
program's ``inner.solve`` spans (one cg, bicgstab or gmres solve an outer
product, one host read an iteration), their wall against the device's busy
union, in the traced run's device-only solve."""

from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Spectral transform"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    solve = traced_solve(run)
    return None if solve is None else solve.idle_pct(("inner.solve",))
