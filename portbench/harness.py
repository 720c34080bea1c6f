"""One run of one cell: set-up, a closed loop of solves, the comparison.

:func:`run` is the whole of a run; ``run.py`` is its command line.  In
order, a run

1. builds the cell's matrix from the benchmark's frozen generators and
   hands it to the program's ``as_operator``, which builds the operator on
   the card (the program builds its kernels and host libraries into
   ``build/`` inside the checkout, at fixed paths, on first use);
2. warms up with one call of the cell's own entry point and shapes, its
   tolerance loosened and, where the traffic says so, its sweeps cut
   (the traffic's ``warmup``), from its own seed;
3. runs solves back to back for ``seconds`` (a closed loop: one caller
   waiting on each answer), each from a start drawn from ``(seed, solve
   index)``; the solve in flight when the time runs out is finished and
   counted, and each answer is copied to the host as it comes;
4. with ``trace``, profiles the window's first solve for the device's
   busy time and its second for the spans, and reads the per-layer
   metrics;
5. frees the program's state and judges every answer of the window with
   the plain reference, then prints the result line.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from .catalog import Catalog
from . import generators
from .peaks import peak
from .reference.judge import cell_judge, verdict, worst
from .spans import Recorder

#: Top-level module names that may not be loaded by the time the window
#: closes: JAX and the JAX package (compared as whole names).
BANNED = ("jax", "jaxlib", "flax", "arnoldi_tpu")


def banned_modules(modules=None):
    """The banned top-level names present in ``modules`` (sys.modules)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None
                                              else modules)}
    return sorted(tops.intersection(BANNED))


def solve_generator(seed, index):
    """The CPU ``torch.Generator`` of solve ``index`` (-1: the warm-up)
    of a run with ``seed``; any whole number is a seed."""
    import torch

    seed = int(seed)
    entropy = [abs(seed) % 2**64, abs(seed) >> 64, int(seed < 0),
               0 if index >= 0 else 1, max(index, 0)]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def _host(value):
    """An answer's tensor as a float64 (complex128) host array."""
    import torch

    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    value = np.asarray(value)
    return value.astype(np.complex128 if np.iscomplexobj(value) else np.float64)


def _power_limit():
    """The card's power limit in watts, from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class RunData:
    """What a per-layer metric's reader reads: the device timeline of the
    first profiled solve (``timeline``), the trace of the second
    (``trace``) and what its spans captured (``calls``), every completed
    solve's counters (``counters``), the stored nonzeros of the
    benchmark's own matrix (``matrix["nnz"]``) and the card's peaks."""

    def __init__(self, timeline, trace, calls, counters, matrix, peaks):
        self.timeline, self.trace, self.calls = timeline, trace, calls
        self.counters, self.matrix, self.peaks = counters, matrix, peaks

    def roofline(self, span, nbytes):
        """Percent of the HBM roofline: ``nbytes`` over the device seconds
        launched inside ``span`` at the card's peak bandwidth; None when
        there is nothing to read (no trace, no such span, no peak)."""
        if self.trace is None or self.peaks is None or not nbytes:
            return None
        seconds = self.trace.span_device_s(span)
        if not seconds:
            return None
        return 100.0 * nbytes / (seconds * self.peaks["hbm_bytes_per_s"])


def _profiled(phase, cuda, recorder, sync, solve):
    """Run ``solve()`` under ``torch.profiler``: ``phase`` "device" records
    device activity alone, "spans" host activity too, inside the window
    span, with the span wrappers recording.  Returns the solve's answer and
    counters and ``(profile, seconds)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if phase == "device":
        activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    else:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    sync()
    prof.start()
    recorder.on = phase == "spans"
    t0 = time.perf_counter()
    try:
        with record_function("pb:window"):
            answer, count = solve()
            sync()
    finally:
        seconds = time.perf_counter() - t0
        recorder.on = False
        prof.stop()
    return answer, count, (prof, seconds)


def _say(err, msg):
    print(msg, file=err, flush=True)


def run(workload, seed, seconds, trace, *, root=None, started=None,
        device="cuda", require_card=True, out=None, err=None):
    """One run; returns the exit code (0 with a result line printed).

    ``device`` and ``require_card=False`` exist for the benchmark's own
    CPU tests, which drive a run without a card; the command line always
    asks for the card.
    """
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    started = time.perf_counter() if started is None else started
    catalog = Catalog(root)
    cell = catalog.workload(workload)
    config = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])

    import torch

    if require_card:
        if not torch.cuda.is_available():
            _say(err, "no CUDA device: the benchmark measures the card only")
            return 3
        if torch.cuda.device_count() < int(cell["chips"]):
            _say(err, f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"asks for {cell['chips']}")
            return 3
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    import arnoldi_tpu_torch as port

    A = generators.build(config)
    matrix = {"nnz": int(A.nnz)}
    op = port.as_operator(A, dtype=getattr(torch, config["dtype"]),
                          format=config["format"], device=device)
    del A
    entry = catalog.entry(traffic["entry"])
    args = dict(traffic["args"])

    recorder = Recorder()
    layer_metrics = {}
    if trace:
        # the program's phase clock, read by a host-tier metric
        os.environ["ARNOLDI_PHASES"] = "1"
        for m in catalog.cell_metrics(workload, "per_layer"):
            module = catalog.metric(m["name"])
            layer_metrics[m["name"]] = (m, module)
            for span, targets in module.SPANS.items():
                for target, capture in targets:
                    if not recorder.wrap(span, target, capture):
                        _say(err, f"{m['name']}: span target {target} is gone")

    # -- set-up: one call of the cell's own shapes, tolerance loosened ----
    try:
        entry.solve(op, {**args, **traffic.get("warmup", {})}, solve_generator(seed, -1))
    except RuntimeError as exc:     # a warm-up cut short by its sweep limit
        if "converged" not in str(exc):
            raise
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = time.perf_counter() - started

    # -- the window ---------------------------------------------------------
    # A traced run profiles two solves: the first with device activity only
    # (the busy share, with the least host overhead), the second with host
    # activity too (the spans, and what the host did in the idle gaps).
    phases = ("device", "spans") if trace else ()
    profiles = {}
    answers, counters, errors = [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    deadline = t0 + float(seconds)
    index = 0
    walls = []
    while True:
        phase = phases[index] if index < len(phases) else None
        t_solve = time.perf_counter()
        try:
            if phase is None:
                answer, count = entry.solve(op, args, solve_generator(seed, index))
            else:
                answer, count, profiles[phase] = _profiled(
                    phase, cuda, recorder, sync,
                    lambda: entry.solve(op, args, solve_generator(seed, index)))
            answers.append({k: _host(v) for k, v in answer.items()})
            counters.append(count)
            walls.append(f"{time.perf_counter() - t_solve:.3f} s "
                         f"({count.get('matvecs')} matvecs)")
            del answer
        except (ValueError, RuntimeError) as exc:     # no convergence, breakdown
            errors.append(f"solve {index}: {type(exc).__name__}: {exc}")
        index += 1
        if time.perf_counter() >= deadline and index >= len(phases):
            break
    sync()
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = index

    found = banned_modules()
    if found:
        _say(err, "modules of JAX or the JAX package were loaded: "
                  + ", ".join(found))
        return 4

    # -- the program's state freed before the reference runs --------------
    recorder.restore()
    del op
    if cuda:
        torch.cuda.empty_cache()

    result_metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if cuda:
        device_info["power_limit_w"] = _power_limit()
    completed = len(answers)
    if not trace:
        # ``<metric>.<class>`` is ``<metric>`` in the cells of a class that
        # has a bound of its own (BENCHMARK.json lists them)
        values = {"setup_s": setup_s,
                  "solve_s": window_s / max(completed, 1),
                  "peak_mem_gib": window_peak / 2**30}
        for m in catalog.cell_metrics(workload, "end_to_end"):
            base = m["name"].split(".", 1)[0]
            if base in values:
                result_metrics[m["name"]] = {"value": values[base],
                                             "unit": m["unit"]}
    else:
        from .devtrace import Timeline, Trace

        t_read = time.perf_counter()
        timeline = trace_data = None
        if "device" in profiles:
            timeline = Timeline(*profiles.pop("device"))
            device_info["busy_s"] = timeline.busy_s
            device_info["window_s"] = timeline.window_s
        if "spans" in profiles:
            trace_data = Trace(profiles.pop("spans")[0])
        breakdown = {"device_ops": [] if timeline is None else timeline.device_ops(),
                     "idle_gaps": [] if trace_data is None else trace_data.idle_gaps()}
        if trace_data is not None:
            _say(err, f"trace: {len(trace_data.device)} device operations "
                      f"({trace_data.unlaid} not laid to a launch, "
                      f"{trace_data.linked} through the linked op), read in "
                      f"{time.perf_counter() - t_read:.2f} s")
        data = RunData(timeline, trace_data, recorder.calls, counters, matrix,
                       peak(device_info["kind"]))
        for name, (m, module) in layer_metrics.items():
            value = module.read(data)
            if value is not None and math.isfinite(value):
                result_metrics[name] = {"value": value, "unit": m["unit"]}
            else:
                _say(err, f"{name}: nothing to read")

    # -- the comparison -------------------------------------------------------
    judge = cell_judge(catalog, cell)
    readings = []
    failed = len(errors)
    for i, answer in enumerate(answers):
        numbers = judge.numbers(answer)
        readings.append(numbers)
        if not verdict(numbers, cell["limits"])[0]:
            failed += 1
    numbers = worst(readings)
    ok, checks = verdict(numbers, cell["limits"]) if numbers else (False, {})
    correct = bool(ok and failed == 0 and attempted > 0)

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    _say(err, "solves: " + "; ".join(walls))
    for line in errors:
        _say(err, line)
    _say(err, f"{workload}: {attempted} solves in {window_s:.3f} s, set-up "
              f"{setup_s:.3f} s, {failed} failed")
    for name, c in checks.items():
        _say(err, f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), file=out, flush=True)
    return 0
