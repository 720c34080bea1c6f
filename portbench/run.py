"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, the last of standard output, and the
numbers the comparison held against their limits as the last lines of
standard error.  Exits nonzero, with no result, when there is no CUDA card
(or fewer than the cell asks for) or when JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Run as a script, this file's folder heads sys.path; the checkout's root
# takes its place, so that the package and the program import by name.
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from portbench.harness import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace),
               root=ROOT, started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
