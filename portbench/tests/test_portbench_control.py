"""The comparison fails what it has to fail: the float32 control put in
the program's place, and runs with the timed path broken underneath."""

import io
import json

import numpy as np
import pytest
import torch

import arnoldi_tpu_torch as port
from portbench.catalog import Catalog
from portbench.harness import run
from portbench.reference.control import FAULTS, control_answer, fault_answer
from portbench.reference.judge import Judge, verdict

from .conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _judge(root, cell):
    cat = Catalog(root)
    wl = cat.workload(cell)
    traffic = cat.traffic(wl["traffic"])
    kind = cat.entry(traffic["entry"]).KIND
    return Judge(cat.config(wl["config"]), traffic["want"]), kind, wl["limits"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**35 + 3, 7])
def test_the_control_fails(tiny_root, cell, seed):
    judge, kind, limits = _judge(tiny_root, cell)
    ok, checks = verdict(judge.numbers(control_answer(judge, kind, seed)), limits)
    assert not ok, checks


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails(tiny_root, cell, fault):
    judge, kind, limits = _judge(tiny_root, cell)
    assert not verdict(judge.numbers(fault_answer(judge, kind, fault, 5)), limits)[0]


def _broken(fault, kind):
    """Wrap a program entry so that its answer carries ``fault``."""
    def wrap(fn):
        def broken(*args, **kwargs):
            out = list(fn(*args, **kwargs))
            if kind == "schur":
                Q, T = out[0], out[1]
            else:
                vals, V = np.array(out[0], dtype=np.float64), out[1]
            if fault == "unchanged":       # the start state comes back
                g = torch.Generator().manual_seed(0)
                W = torch.randn(Q.shape if kind == "schur" else V.shape,
                                generator=g, dtype=torch.float64)
                W = torch.linalg.qr(W)[0]
                if kind == "schur":
                    Q = W
                else:
                    V = W
            elif fault == "half":
                if kind == "schur":
                    h = Q.shape[1] // 2
                    Q, T = Q[:, :h], T[:h, :h]
                else:
                    h = V.shape[1] // 2
                    vals, V = vals[:h], V[:, :h]
            elif fault == "altered":
                if kind == "schur":
                    T = T.clone()
                    T[0, 0] += 1e-6
                else:
                    vals[0] += 1e-6
            if kind == "schur":
                out[0], out[1] = Q, T
            else:
                out[0], out[1] = vals, V
            return tuple(out)
        return broken
    return wrap


ENTRIES = {"partial_schur": "schur", "partial_eigh": "eigh", "eigsh": "eigh",
           "eigsh_window": "eigh"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_run_is_not_correct(tiny_root, monkeypatch, cell, fault):
    traffic = Catalog(tiny_root).traffic(Catalog(tiny_root).workload(cell)["traffic"])
    name = traffic["entry"]
    monkeypatch.setattr(port, name, _broken(fault, ENTRIES[name])(getattr(port, name)))
    out = io.StringIO()
    assert run(cell, 11, 0.01, False, root=tiny_root, device="cpu",
               require_card=False, out=out, err=io.StringIO()) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is False and line["failed"] >= 1
