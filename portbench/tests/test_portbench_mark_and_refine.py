"""The cells ``mark1000-schur-lr`` and ``l3d64-window-f32``: the catalog
finds them, their two per-layer metrics read on made-up runs (and nothing
where their spans are absent), the stored spectrum of ``mark-1000`` is
that of the matrix its configuration builds.  The mark cell's limits
against the float32 control and the planted faults: the control tests
(``test_portbench_control.py``), with the judge ``conftest.py`` gives
them."""

import numpy as np
import pytest
import torch

import arnoldi_tpu_torch as port
from portbench import generators, program_spans
from portbench.catalog import Catalog
from portbench.devtrace import Timeline
from portbench.harness import RunData
from portbench.reference.sparse import MARGIN, RESIDUAL_MAX, matrix_record, operator
from portbench.spans import Recorder

from .conftest import ROOT
from .test_portbench_devtrace import Ev, Prof
from .test_portbench_program_spans import Run, Span

#: Each new cell: its configuration, traffic, peak metric and own metric.
CELLS = {"mark1000-schur-lr": ("mark-1000", "schur-lr-k5-m40",
                               "peak_mem_gib.start_dependent", "spmv_ell.roofline_pct"),
         "l3d64-window-f32": ("laplace3d-64", "window-60-f32",
                              "peak_mem_gib.start_dependent", "refine.share_pct")}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_catalog_finds_the_cell(cell):
    config, traffic, peak, metric = CELLS[cell]
    cat = Catalog(ROOT)
    assert cell in cat.names("workloads")
    wl = cat.workload(cell)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (config, traffic, 1)
    assert cat.config(config)["name"] == config
    assert cat.traffic(traffic)["entry"] in cat.names("entries")
    assert [m["name"] for m in cat.cell_metrics(cell, "end_to_end")] == [
        "setup_s", "solve_s", peak]
    per_layer = [m["name"] for m in cat.cell_metrics(cell, "per_layer")]
    assert metric in per_layer and "device.idle_unspanned_pct" in per_layer
    assert "solver.matvecs_per_solve" in per_layer
    # each new metric reads in its own cell only
    assert [m["name"] for m in cat.cell_metrics("l2d724-schur-lm", "per_layer")
            if m["name"] == metric] == []


def test_the_float32_window_is_the_window_in_float32():
    cat = Catalog(ROOT)
    f32, f64 = cat.traffic("window-60-f32"), cat.traffic("window-60")
    assert f32["args"] == {**f64["args"], "dtype": "float32", "refine": "auto"}
    assert f32["want"] == f64["want"]
    # the warm-up reaches the float64 continuation: below 1e-6, no sweep cap
    assert f32["warmup"]["tol"] < 1e-6 and "max_iters" not in f32["warmup"]


class _Trace:
    """A made-up trace: ``seconds`` of device time inside ``span``."""

    def __init__(self, span, seconds):
        self.span, self.seconds = span, seconds

    def span_device_s(self, span):
        return self.seconds if span == self.span else 0.0


PEAKS = {"hbm_bytes_per_s": 3.35e12}


def test_spmv_ell_roofline_counts_each_product():
    """The ELL operator's products on the CPU, captured by the metric's
    span wrappers, over a made-up device time."""
    module = Catalog(ROOT).metric("spmv_ell.roofline_pct")
    A = generators.build({"generator": "mark", "args": {"m": 10}, "dtype": "float64"})
    op = port.as_operator(A, format="ell", device="cpu")
    n = op.shape[0]
    recorder = Recorder()
    for span, targets in module.SPANS.items():
        for target, capture in targets:
            assert recorder.wrap(span, target, capture)
    recorder.on = True
    try:
        op.matvec(torch.ones(n, dtype=torch.float64))
        op.matvec(torch.ones(n, dtype=torch.float64))
        op.matmat_rows(torch.ones((3, n), dtype=torch.float64))
    finally:
        recorder.on = False
        recorder.restore()
    assert recorder.calls["spmv_ell"] == [(n, 1, 8), (n, 1, 8), (n, 3, 8)]
    nbytes = 8 * (3 * A.nnz + 2 * n * (1 + 1 + 3))
    data = RunData(None, _Trace("spmv_ell", 1e-6), recorder.calls, [],
                   {"nnz": A.nnz}, PEAKS)
    assert module.read(data) == pytest.approx(100 * nbytes / (1e-6 * 3.35e12))
    # no span, or no trace: nothing to read
    assert module.read(RunData(None, _Trace("spmv", 1e-6), recorder.calls, [],
                               {"nnz": A.nnz}, PEAKS)) is None
    assert module.read(RunData(None, None, {}, [], {"nnz": A.nnz}, PEAKS)) is None


def _timeline():
    return Timeline(Prof([Ev("a", 100, 300, device=True),
                          Ev("b", 600, 900, device=True)]), 1e-3)


#: Solve 0 over 0-1000 us, its slices refined over 300-450 and 700-800 us.
REFINED = [Span("solve", 0, 1000, 0),
           Span("filter.sweep", 100, 300, 0, 0),
           Span("refine.filter", 300, 450, 0, 0, 40),
           Span("filter.sweep", 500, 700, 0, 0),
           Span("refine.filter", 700, 800, 0, 0, 30)]


@pytest.mark.parametrize("spans, share", [(REFINED, 25.0),
                                          (REFINED[:2] + REFINED[3:4], None),
                                          ([], None)],
                         ids=["refined", "unrefined", "no-spans"])
def test_refine_share_reads_the_refined_slices(monkeypatch, spans, share):
    monkeypatch.setattr(program_spans, "program_spans", lambda: list(spans) or None)
    module = Catalog(ROOT).metric("refine.share_pct")
    value = module.read(Run(_timeline()))
    assert value == (None if share is None else pytest.approx(share))
    assert module.read(Run(None)) is None


@pytest.fixture(scope="module")
def mark_1000():
    cat = Catalog(ROOT)
    config = cat.config("mark-1000")
    return config, operator(config), cat.spectrum("mark-1000")


def test_the_stored_spectrum_is_of_the_configured_matrix(mark_1000):
    config, A, spectrum = mark_1000
    assert config["generator"] == "mark" and config["args"] == {"m": 1000}
    assert spectrum["matrix"] == matrix_record(config, A)
    assert (A.shape[0], A.nnz) == (500500, 1998000)
    lr = spectrum["wants"]["LR"]
    k = Catalog(ROOT).traffic("schur-lr-k5-m40")["want"]["k"]
    assert lr["k"] >= k + MARGIN and len(lr["values"]) == lr["k"]
    assert max(lr["residuals"]) <= RESIDUAL_MAX
    values = np.array([complex(re, im) for re, im in lr["values"]])
    assert not np.any(values.imag)
    assert np.all(np.diff(values.real) <= 0)      # most wanted first
    assert abs(values[0] - 1) <= 1e-12 and abs(spectrum["radius"] - 1) <= 1e-3
    # lambda_2 = 0.9999948, as Saad's example gives it
    assert abs(values[1].real - 0.9999948) <= 1e-7

