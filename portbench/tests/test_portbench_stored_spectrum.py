"""A configuration that brings its own generator and reference: the
spectrum command, the judge on a stored spectrum with its control and
faults, a run of such a cell, and the grid judge's numbers kept."""

import io
import json
import math

import numpy as np
import pytest

import arnoldi_tpu_torch as port
from portbench.catalog import Catalog
from portbench.harness import run
from portbench.reference import sparse
from portbench.reference import spectrum as command
from portbench.reference.control import FAULTS, control_answer, fault_answer
from portbench.reference.judge import Judge, cell_judge, verdict
from portbench.reference.sparse import SparseJudge

from .conftest import MARK, MARK_CELL
from .test_portbench_control import _broken

LIMITS = MARK["workloads/mark40-schur-lr.json"]["limits"]


def _stored(root, name="mark-40"):
    return Catalog(root).spectrum(name)


def _mark_judge(root):
    cat = Catalog(root)
    return cell_judge(cat, cat.workload(MARK_CELL))


@pytest.mark.parametrize("dense_max", [sparse.DENSE_MAX, 0], ids=["eig", "arpack"])
def test_the_command_agrees_with_dense_eigvals(tmp_path, monkeypatch, dense_max):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "mark-40.json").write_text(
        json.dumps(MARK["configs/mark-40.json"]))
    monkeypatch.setattr(sparse, "DENSE_MAX", dense_max)
    assert command.main(["--config", "mark-40", "--want", "LR", "--k", "15",
                         "--root", str(tmp_path)]) == 0
    stored = _stored(tmp_path)["wants"]["LR"]
    assert stored["solver"].endswith("eig" if dense_max else "eigs")
    vals = np.array([complex(*v) for v in stored["values"]])
    dense = np.linalg.eigvals(sparse.operator(MARK["configs/mark-40.json"]).toarray())
    dense = dense[np.argsort(-dense.real, kind="stable")][:15]
    np.testing.assert_allclose(vals, dense, rtol=0, atol=1e-12)
    assert max(stored["residuals"]) <= 1e-12
    assert abs(_stored(tmp_path)["radius"] - 1) < (1e-12 if dense_max else sparse.RADIUS_TOL)


def test_the_command_refuses_a_large_residual(tmp_path, monkeypatch):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "configs" / "mark-40.json").write_text(
        json.dumps(MARK["configs/mark-40.json"]))
    monkeypatch.setattr(sparse, "RESIDUAL_MAX", 1e-20)
    assert command.main(["--config", "mark-40", "--want", "LR", "--k", "15",
                         "--root", str(tmp_path)]) == 1
    assert not (tmp_path / "portbench" / "spectra").exists()


def test_the_judge_is_picked_by_the_generator(tiny_root, mark_root):
    assert isinstance(_mark_judge(mark_root), SparseJudge)
    cat = Catalog(tiny_root)
    for cell in ("l3d64-window", "l2d724-schur-lm"):
        assert type(cell_judge(cat, cat.workload(cell))) is Judge


def test_a_spectrum_of_another_matrix_is_refused(mark_root):
    config = dict(MARK["configs/mark-40.json"], args={"m": 41})
    with pytest.raises(ValueError, match="computed for"):
        SparseJudge(config, {"want": "LR", "k": 5}, _stored(mark_root))
    with pytest.raises(ValueError, match="needs k"):
        SparseJudge(MARK["configs/mark-40.json"], {"want": "LR", "k": 6}, _stored(mark_root))


@pytest.mark.parametrize("kind", ["schur", "eigh"])
def test_the_exact_answer_passes_and_the_control_fails(mark_root, kind):
    judge = _mark_judge(mark_root)
    values, V = judge.exact_answer()
    exact = ({"Q": np.linalg.qr(V)[0]} if kind == "schur"
             else {"values": values, "vectors": V})
    if kind == "schur":
        exact["T"] = exact["Q"].T @ judge.apply(exact["Q"])
    assert verdict(judge.numbers(exact), LIMITS)[0]
    for seed in (1, 2**35 + 3, 7):
        ok, checks = verdict(judge.numbers(control_answer(judge, kind, seed)), LIMITS)
        assert not ok, checks


@pytest.mark.parametrize("kind", ["schur", "eigh"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_caught(mark_root, kind, fault):
    judge = _mark_judge(mark_root)
    assert not verdict(judge.numbers(fault_answer(judge, kind, fault, 5)), LIMITS)[0]


def test_complex_answers_stay_complex(mark_root):
    judge = _mark_judge(mark_root)
    values, V = judge.exact_answer()
    phase = np.exp(1j * np.linspace(0, 1, values.size))
    numbers = judge.numbers({"values": values.astype(complex), "vectors": V * phase})
    assert verdict(numbers, LIMITS)[0]
    numbers = judge.numbers({"values": values + 1e-6j, "vectors": V * phase})
    assert numbers["value_err"] == pytest.approx(1e-6, rel=1e-6)


@pytest.mark.parametrize("fault", [None, "altered"])
def test_a_run_of_the_cell(mark_root, monkeypatch, fault):
    if fault:
        monkeypatch.setattr(port, "partial_schur",
                            _broken(fault, "schur")(port.partial_schur))
    out = io.StringIO()
    assert run(MARK_CELL, 2**33 + 7, 0.01, False, root=mark_root, device="cpu",
               require_card=False, out=out, err=io.StringIO()) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is (fault is None), line["checks"]


#: The grid judge's numbers at test size (seed 1) as they were before the
#: stored-spectrum reference was added, which it may not move.
#: Rounding-level numbers may differ in their last bits with another BLAS.
PINNED = {
    "l3d64-window": {
        "control": (4.589853185185978e-08, 1.685961392329605e-07, 1.664271627177527e-07, 0),
        "unchanged": (0.4069600493404645, 0.21080895381377845, 8.881784197001252e-16, 0),
        "half": (0.0, 3.8836005741213046e-16, 8.881784197001252e-16, 12),
        "altered": (1.0000000000155212e-06, 1.0000000000255014e-06, 8.881784197001252e-16, 0)},
    "l2d724-schur-lm": {
        "control": (3.093933678095492e-08, 7.200328467021976e-07, 1.4394567674717168e-06, 0),
        "unchanged": (0.0012111056930432878, 0.25260570148793715, 4.440892098500626e-16, 231),
        "half": (0.0, 1.877568353634317e-15, 2.0539125955565396e-15, 3),
        "altered": (9.999999999465086e-07, 1.000000000003055e-06, 1.0047518372857667e-14, 0)},
    "l2d724-eigh-la": {
        "control": (1.403356522778084e-08, 4.72354223605361e-08, 1.4717540686159936e-07, 0),
        "unchanged": (0.0017648786352869917, 0.25282615483340876, 4.440892098500626e-16, 230),
        "half": (0.0, 5.795208449276628e-17, 2.220446049250313e-16, 3),
        "altered": (9.999999999999885e-07, 1.0000000000033525e-06, 6.661338147750939e-16, 0)},
    "l2d724-sinv-cg": {
        "control": (1.403356522778084e-08, 4.72354223605361e-08, 1.4717540686159936e-07, 0),
        "unchanged": (0.0017648786352869917, 0.25282615483340876, 4.440892098500626e-16, 230),
        "half": (0.0, 5.795208449276628e-17, 2.220446049250313e-16, 3),
        "altered": (9.999999999999885e-07, 1.0000000000033525e-06, 6.661338147750939e-16, 0)},
}


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_the_grid_numbers_are_pinned(tiny_root, cell):
    cat = Catalog(tiny_root)
    wl = cat.workload(cell)
    judge = cell_judge(cat, wl)
    kind = cat.entry(cat.traffic(wl["traffic"])["entry"]).KIND
    for name, want in PINNED[cell].items():
        answer = (control_answer(judge, kind, 1) if name == "control"
                  else fault_answer(judge, kind, name, 1))
        got = judge.numbers(answer)
        for number, value in zip(("value_err", "residual", "orth", "missing"), want):
            assert math.isclose(got[number], value, rel_tol=1e-6, abs_tol=1e-13), \
                (name, number, got[number], value)
