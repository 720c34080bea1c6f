"""Milliseconds of the ordered Schur form of the small Hessenberg matrix on
the host, per restart: the program's phase clock's ``rotate`` total over
its calls, summed over the window's solves.  It runs after H is on the
host, so the host clock measures it whole."""

UNIT = "ms"
LAYER = "Host dense tier"
MOVES = "solve_s"
SOURCE = "program_span"
BETTER = "lower"
SPANS = {}


def read(run):
    seconds = calls = 0
    for c in run.counters:
        phase = (c.get("phases") or {}).get("rotate")
        if phase:
            seconds += phase["seconds"]
            calls += phase["calls"]
    return 1e3 * seconds / calls if calls else None
