"""The five program-span readers on made-up spans and a made-up device
timeline: the solve they pick, the idle time they split by span, and
nothing to read without spans or a timeline."""

import pytest

from portbench import program_spans
from portbench.catalog import Catalog
from portbench.devtrace import Timeline

from .conftest import ROOT
from .test_portbench_devtrace import US, Ev, Prof

READERS = ("expand.idle_pct", "restart.idle_ms_per_restart", "inner.idle_pct",
           "filter.idle_pct", "device.idle_unspanned_pct")


class Span:
    def __init__(self, name, start, end, solve, parent=None, count=None):
        self.name, self.start_ns, self.end_ns = name, start * US, end * US
        self.solve, self.parent, self.count = solve, parent, count


#: Solve 0 over 0-1000 us holds the device's work; solve 1, later, none.
SPANS = [
    Span("solve", 0, 1000, 0),
    Span("expand", 100, 400, 0, 0),
    Span("matvec", 100, 150, 0, 1),
    Span("ortho", 150, 400, 0, 1),
    Span("restart", 400, 500, 0, 0, 0),
    Span("h_pull", 400, 420, 0, 4),
    Span("rotate", 420, 480, 0, 4),
    Span("expand", 500, 800, 0, 0),
    Span("matvec", 500, 700, 0, 7),
    Span("inner.solve", 550, 650, 0, 8, 40),
    Span("filter.sweep", 820, 880, 0, 0),
    Span("filter.ghost_gate", 880, 950, 0, 0),
    Span("solve", 5000, 6000, 1),
    Span("expand", 5000, 6000, 1, 12),
]


def _timeline():
    # busy 120-300, 600-700, 850-900 us
    return Timeline(Prof([Ev("a", 120, 300, device=True),
                          Ev("b", 600, 650, device=True),
                          Ev("c", 640, 700, device=True),
                          Ev("d", 850, 900, device=True)]), 1e-3)


class Run:
    def __init__(self, timeline):
        self.timeline = timeline


@pytest.fixture
def readers(monkeypatch):
    monkeypatch.setattr(program_spans, "program_spans", lambda: list(SPANS))
    cat = Catalog(ROOT)
    return {name: cat.metric(name) for name in READERS}


def test_the_solve_holding_the_busy_time_is_read(readers):
    solve = program_spans.traced_solve(Run(_timeline()))
    assert solve.solve.start_ns == 0
    assert {s.solve for s in solve.spans} == {0}
    assert solve.busy == [(120 * US, 300 * US), (600 * US, 700 * US),
                          (850 * US, 900 * US)]


def test_idle_split_by_span(readers):
    run = Run(_timeline())
    value = {name: readers[name].read(run) for name in READERS}
    # expand: 600 us of wall, 280 busy
    assert value["expand.idle_pct"] == pytest.approx(100 * 320 / 600)
    # one restart, idle throughout its 100 us
    assert value["restart.idle_ms_per_restart"] == pytest.approx(0.1)
    # inner.solve 550-650: busy from 600
    assert value["inner.idle_pct"] == pytest.approx(50.0)
    # the sweep and the gate: 130 us, 50 busy
    assert value["filter.idle_pct"] == pytest.approx(100 * 80 / 130)
    # the solve idles 670 us, 500 of them inside its spans
    assert value["device.idle_unspanned_pct"] == pytest.approx(100 * 170 / 670)


def test_nothing_to_read_without_spans_or_a_timeline(readers, monkeypatch):
    for name in READERS:
        assert readers[name].read(Run(None)) is None
        assert readers[name].read(Run(Timeline(Prof([]), 1e-3))) is None
    monkeypatch.setattr(program_spans, "program_spans", lambda: None)
    for name in READERS:
        assert readers[name].read(Run(_timeline())) is None


def test_a_span_that_never_opened_reads_nothing(readers, monkeypatch):
    monkeypatch.setattr(program_spans, "program_spans",
                        lambda: [s for s in SPANS if s.name != "restart"])
    assert readers["restart.idle_ms_per_restart"].read(Run(_timeline())) is None
    assert readers["expand.idle_pct"].read(Run(_timeline())) is not None


def test_interval_helpers():
    assert program_spans.merged([(0, 5), (3, 8), (10, 12), (11, 11)]) == [
        (0, 8), (10, 12)]
    assert program_spans.overlap_ns([(0, 8), (10, 12)], [(5, 11)]) == 4
    assert program_spans.length_ns([(0, 8), (10, 12)]) == 10


def test_the_program_records_what_the_helper_reads(monkeypatch):
    import torch

    import arnoldi_tpu_torch as port
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.utils import profiling

    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    profiling.clear()
    try:
        op = port.as_operator(matrices.laplace_2d(12), device="cpu",
                              dtype=torch.float64)
        port.partial_schur(op, 3, max_dim=12, ortho="cgs2")
        spans = program_spans.program_spans()
    finally:
        profiling.clear()
    names = {s.name for s in spans}
    assert {"solve", "expand", "restart", "rotate"} <= names
