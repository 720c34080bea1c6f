"""The readings that a cell's limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... [--solves 1]
        [--control-seeds 1,2,3]

In one process (set-up once): for each seed, ``--solves`` solves of the
timed path as a run makes them (the same entry, operator, arguments and
start vectors: seed and solve index), each judged by the reference; then
the control (the reference in float32) and each planted fault of
``reference/control.py`` on every control seed.  Prints one JSON line per
reading and, last, the largest reading of the program and the smallest of
the control and the faults for each number.  The benchmark's own runs do
not run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--solves", type=int, default=1)
    parser.add_argument("--control-seeds", default="1,2,3")
    args = parser.parse_args(argv)

    import torch

    import arnoldi_tpu_torch as port
    from portbench import generators
    from portbench.catalog import Catalog
    from portbench.harness import _host, solve_generator
    from portbench.reference.control import FAULTS, control_answer, fault_answer
    from portbench.reference.judge import NUMBERS, cell_judge

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cat = Catalog(ROOT)
    cell = cat.workload(args.workload)
    config, traffic = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    entry = cat.entry(traffic["entry"])
    op = port.as_operator(generators.build(config), dtype=getattr(torch, config["dtype"]),
                          format=config["format"], device="cuda")
    judge = cell_judge(cat, cell)

    def emit(obj):
        print(json.dumps(obj), flush=True)

    program, others = [], {}
    for seed in (int(s) for s in args.seeds.split(",")):
        for index in range(args.solves):
            t0 = time.perf_counter()
            answer, count = entry.solve(op, traffic["args"], solve_generator(seed, index))
            host = {k: _host(v) for k, v in answer.items()}
            wall = time.perf_counter() - t0
            numbers = judge.numbers(host)
            program.append(numbers)
            emit({"reading": "program", "seed": seed, "solve": index, "wall_s": wall,
                  "matvecs": count.get("matvecs"), "numbers": numbers})
    del op
    for seed in (int(s) for s in args.control_seeds.split(",")):
        kinds = {"control": control_answer(judge, entry.KIND, seed)}
        kinds.update((f, fault_answer(judge, entry.KIND, f, seed)) for f in FAULTS)
        for kind, answer in kinds.items():
            numbers = judge.numbers(answer)
            others.setdefault(kind, []).append(numbers)
            emit({"reading": kind, "seed": seed, "numbers": numbers})
    emit({"workload": args.workload,
          "lower": {n: max(r[n] for r in program) for n in NUMBERS},
          "upper": {kind: {n: min(r[n] for r in rs) for n in NUMBERS}
                    for kind, rs in others.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
