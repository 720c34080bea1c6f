"""The port's span recorder (``utils/profiling.py``) on the CPU.

Off, the phase clock is the shared no-op and records nothing.  On, every
phase is a span of the process-wide log with its parent and solve id, a
public driver's call is one ``solve`` span (a nested driver opens none),
the drivers of the benchmark's four cells open the spans of their layers
with their counts, ``History.phases`` keeps its keys, and the spans share
``torch.profiler``'s clock.  No JAX here: the recorder needs no reference.
"""

import threading
from collections import Counter

import pytest
import torch

import arnoldi_tpu_torch as port
from arnoldi_tpu_torch import matrices
from arnoldi_tpu_torch.solvers.spectral_transform import accounting
from arnoldi_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def phases_on(monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    profiling.clear()
    yield
    profiling.clear()


def _closed():
    return list(profiling.spans())


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_returns_the_shared_noop_and_records_nothing(monkeypatch):
    monkeypatch.delenv("ARNOLDI_PHASES", raising=False)
    profiling.clear()
    clock = profiling.phase_clock()
    assert clock is profiling.NULL_CLOCK
    assert clock("expand") is clock("ortho")           # one null context
    with clock("expand") as phase:
        phase.count = 3
    assert clock.report() == {}
    op = port.as_operator(matrices.laplace_2d(12), device="cpu")
    Q, T, hist = port.partial_schur(op, 3, max_dim=12, ortho="cgs2")
    assert hist.phases == {}
    assert profiling.spans() == () and profiling.dropped() == 0


def test_nesting_parents_and_solve_ids(phases_on):
    clock = profiling.WallClock()

    @profiling.solve_span(lambda out: out)
    def driver(inner_calls):
        with clock("outer"):
            with clock("inner") as phase:
                phase.count = 7
            for _ in range(inner_calls):
                nested(5)
        return 11

    @profiling.solve_span(lambda out: out)
    def nested(n):
        with clock("leaf"):
            return n

    assert driver(2) == 11
    assert driver(0) == 11
    spans = profiling.spans()
    names = [s.name for s in spans]
    assert names == ["solve", "outer", "inner", "leaf", "leaf",
                     "solve", "outer", "inner"]
    first, second = spans[0].solve, spans[5].solve
    assert first is not None and second is not None and first != second
    assert [s.solve for s in spans] == [first] * 5 + [second] * 3
    assert [s.parent for s in spans] == [None, 0, 1, 1, 1, None, 5, 6]
    assert spans[2].count == 7 and spans[0].count == 11
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert clock.report()["leaf"]["calls"] == 2


def test_a_driver_that_counts_nothing_takes_its_nested_calls_sum(phases_on):
    @profiling.solve_span(lambda out: out)
    def counted(n):
        return n

    @profiling.solve_span()
    def outer():
        return counted(3) + counted(4)

    outer()
    (solve,) = _closed()
    assert solve.name == "solve" and solve.count == 7


def test_threads_keep_their_own_parents(phases_on):
    clock = profiling.WallClock()
    barrier = threading.Barrier(4)

    def work():
        with clock("outer"):
            barrier.wait(timeout=30)
            with clock("inner"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = profiling.spans()
    assert Counter(s.name for s in spans) == {"outer": 4, "inner": 4}
    for s in spans:
        if s.name == "inner":
            assert spans[s.parent].name == "outer"
    assert len({s.parent for s in spans if s.name == "inner"}) == 4


def test_the_log_is_bounded_and_counts_what_it_drops():
    log = profiling.SpanLog(capacity=2)
    for i in range(5):
        log.close(log.open(), f"s{i}", i, i + 1)
    assert [s.name for s in log.snapshot()] == ["s0", "s1"]
    assert log.dropped == 3
    slot = log.open()
    log.clear()
    log.close(slot, "late", 0, 1)          # opened before the clear: void
    assert log.snapshot() == () and log.dropped == 0


def _schur(op):
    Q, T, hist = port.partial_schur(op, 5, max_dim=20, ortho="cgs2")
    return hist, {}


def _eigh(op):
    vals, V, hist = port.partial_eigh(op, 5, which="LA", max_dim=20,
                                      ortho="cgs2")
    return hist, {}


def _sinv(op):
    with accounting() as seen:
        port.eigsh(op, k=5, sigma=0.01, ncv=20, inner_solver="cg", tol=1e-8)
    (hist,) = seen["hist"]
    return hist, {"inner_matvecs": sum(s.inner_matvecs for s in seen["stats"]),
                  "inner_solves": sum(s.solves for s in seen["stats"])}


def _window(op):
    vals, V, hist = port.eigsh_window(op, (-11.0, -10.5), tol=1e-8,
                                      generator=torch.Generator().manual_seed(3))
    return hist, {"pairs": len(vals)}


#: The benchmark's four cells at test size: the driver, its operator, the
#: spans it opens, and the ``History.phases`` keys it had before spans.
CELLS = {
    "schur": (_schur, lambda: matrices.laplace_2d(30),
              {"solve", "workspace_setup", "expand", "matvec", "ortho",
               "restart", "h_pull", "rotate", "truncate"},
              {"workspace_setup", "expand", "h_pull", "rotate", "truncate"}),
    "eigh": (_eigh, lambda: matrices.laplace_2d(30),
             {"solve", "workspace_setup", "trl.device_loop", "expand",
              "matvec", "ortho", "restart", "truncate"},
             {"workspace_setup", "trl.device_loop", "expand", "truncate"}),
    "sinv": (_sinv, lambda: matrices.laplace_2d(30),
             {"solve", "workspace_setup", "trl.device_loop", "expand",
              "matvec", "ortho", "inner.solve", "inner.fused", "restart",
              "truncate"},
             {"workspace_setup", "trl.device_loop", "expand", "truncate"}),
    "window": (_window, lambda: matrices.laplace_3d(12),
               {"solve", "filter.bounds", "filter.census", "filter.count_probe",
                "filter.start_block", "filter.sweep", "filter.ghost_gate"},
               {"filter.bounds", "filter.census", "filter.count_probe",
                "filter.sweep"}),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_driver_opens_its_spans(phases_on, cell):
    run, matrix, names, phase_keys = CELLS[cell]
    op = port.as_operator(matrix(), device="cpu")
    hist, extra = run(op)
    spans = _closed()
    by = _by_name(spans)
    assert set(by) == names
    assert phase_keys <= set(hist.phases)
    (solve,) = by["solve"]
    assert {s.solve for s in spans} == {solve.solve}
    assert all(s.start_ns >= solve.start_ns and s.end_ns <= solve.end_ns
               for s in spans)
    if cell == "window":
        assert solve.count == hist.total_matvecs
        sweeps, gates = by["filter.sweep"], by["filter.ghost_gate"]
        assert len(sweeps) == len(gates) == hist.phases["filter.sweep"]["calls"]
        # the sweeps and gates' products, less the census' and count probes'
        swept = sum(s.count for s in sweeps + gates)
        assert 0 < swept < hist.total_matvecs
        assert ([s.count for s in by["filter.start_block"]]
                == [g["s"] for g in hist.slices])
        assert extra["pairs"] > 0
        return
    assert solve.count == hist.total_matvecs
    # every outer product is one step of an expansion
    assert sum(s.count for s in by["expand"]) == hist.total_matvecs
    assert len(by["matvec"]) == len(by["ortho"]) == hist.total_matvecs
    restarts = by["restart"]
    assert [s.count for s in restarts] == list(range(len(restarts)))
    assert len(restarts) == int(hist.restarts.max())
    for s in by["matvec"] + by["ortho"]:
        assert spans[s.parent].name == "expand"
    for name in ("h_pull", "rotate", "truncate"):
        for s in by.get(name, []):
            assert spans[s.parent].name == "restart"
    if cell == "sinv":
        inner = by["inner.solve"]
        assert len(inner) == extra["inner_solves"] == hist.total_matvecs
        assert sum(s.count for s in inner) == extra["inner_matvecs"]
        assert all(spans[s.parent].name == "matvec" for s in inner)
        # a DIA operator, cg, no preconditioner: the fused route, its span
        # inside each inner solve, its count the iterations
        fused = by["inner.fused"]
        assert len(fused) == len(inner)
        assert all(spans[s.parent].name == "inner.solve"
                   and s.count == spans[s.parent].count - 1 for s in fused)


@pytest.mark.parametrize("dtype, refine, tol, refined", [
    (torch.float32, "auto", 1e-8, True),
    (torch.float32, None, 1e-5, False),
    (torch.float64, "auto", 1e-8, False),
], ids=["float32-refined", "float32-unrefined", "float64"])
def test_refine_filter_opens_once_a_refined_slice(phases_on, dtype, refine, tol,
                                                   refined):
    """The float64 continuation of a float32 filter is one ``refine.filter``
    span a slice, inside the call's ``solve``, its count the slice's
    float64 matvecs; an unrefined slice opens none."""
    op = port.as_operator(matrices.laplace_3d(12), device="cpu")
    vals, V, hist = port.eigsh_window(op, (-11.0, -10.5), tol=tol, max_slice=12,
                                      dtype=dtype, refine=refine,
                                      generator=torch.Generator().manual_seed(3))
    assert len(hist.slices) > 1 and len(vals) > 0
    spans = _closed()
    (solve,) = _by_name(spans)["solve"]
    found = _by_name(spans).get("refine.filter", [])
    if not refined:
        assert found == [] and "refine.filter" not in hist.phases
        assert all(g["f64_matvecs"] == 0 for g in hist.slices)
        return
    assert [s.count for s in found] == [g["f64_matvecs"] for g in hist.slices]
    assert all(s.count > 0 and spans[s.parent] == solve for s in found)
    assert hist.phases["refine.filter"]["calls"] == len(hist.slices)
    assert V.dtype == torch.float64


def test_a_nested_driver_opens_no_second_solve(phases_on):
    """``eigsh`` into ``partial_eigh``, ``svds`` into ``partial_eigh``."""
    op = port.as_operator(matrices.laplace_2d(12), device="cpu")
    vals, V = port.eigsh(op, k=3, which="LA", ncv=12)
    A = matrices.laplace_2d(12)[:, :100]
    U, s, Vh = port.svds(A, 2, device="cpu")
    solves = [s for s in _closed() if s.name == "solve"]
    assert len(solves) == 2
    assert solves[0].solve != solves[1].solve
    assert all(sp.solve in (solves[0].solve, solves[1].solve) for sp in _closed())


def test_spans_share_the_profilers_clock(phases_on):
    """A kineto event of an aten op lies inside the program span around it."""
    from torch.profiler import ProfilerActivity, profile

    clock = profiling.WallClock()
    x = torch.randn(300, 300, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with clock("matmul"):
                x = torch.mm(x, x) * 1e-3
    spans = sorted((s.start_ns, s.end_ns) for s in _closed())
    events = sorted((ev.start_ns(), ev.end_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "aten::mm")
    assert len(spans) == len(events) == 5
    slack = 50_000
    for (s0, s1), (e0, e1) in zip(spans, events):
        assert s0 - slack <= e0 and e1 <= s1 + slack
