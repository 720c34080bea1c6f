"""The device's idle share inside the Krylov expansions: the program's
``expand`` spans (``DeviceWorkspace.expand``: each step's product and
orthogonalization, their flag reads and bookkeeping), their wall against
the device's busy union, in the traced run's device-only solve."""

from portbench.program_spans import traced_solve

UNIT = "%"
LAYER = "Expansion"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    solve = traced_solve(run)
    return None if solve is None else solve.idle_pct(("expand",))
