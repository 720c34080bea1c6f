"""Discovery by name, and BENCHMARK.json against the files it names."""

import json
import shutil

import pytest

from portbench.catalog import Catalog
from portbench.spans import resolve

from .conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_file_is_found_by_name():
    cat = Catalog(ROOT)
    assert cat.names("configs") == sorted(c["name"] for c in SPEC["configs"])
    assert cat.names("workloads") == sorted(w["name"] for w in SPEC["workloads"])
    assert cat.names("metrics") == sorted(m["name"] for m in SPEC["per_layer"])
    for w in SPEC["workloads"]:
        assert w["traffic"] in cat.names("traffic")
        assert cat.traffic(w["traffic"])["entry"] in cat.names("entries")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_workload_file_agrees_with_benchmark_json(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = Catalog(ROOT).workload(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key]
    assert set(wl["limits"]) == {"value_err", "residual", "orth", "missing"}
    assert wl["limits"]["missing"] == 0


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_metric_file_agrees_with_benchmark_json(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    module = Catalog(ROOT).metric(name)
    assert (module.UNIT, module.LAYER, module.MOVES, module.SOURCE, module.BETTER) == (
        entry["unit"], entry["layer"], entry["moves"], entry["source"], entry["better"])
    for targets in module.SPANS.values():
        for target, _ in targets:
            assert resolve(target) is not None, target


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith(SPEC["paths"][0] + "/")
    assert cfg["name"] == name and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["args"]) | set(cfg)


def test_cell_metrics_follow_the_workloads_lists():
    cat = Catalog(ROOT)
    names = [m["name"] for m in cat.cell_metrics("l3d64-window", "per_layer")]
    assert "filter.roofline_pct" in names and "ortho.roofline_pct" not in names
    e2e = [m["name"] for m in cat.cell_metrics("l2d724-sinv-cg", "end_to_end")]
    assert e2e == ["setup_s", "solve_s", "peak_mem_gib"]
    e2e = [m["name"] for m in cat.cell_metrics("l3d64-window", "end_to_end")]
    assert e2e == ["setup_s", "solve_s", "peak_mem_gib.start_dependent"]


def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    """Adding a configuration, a traffic mix, a cell and a per-layer metric
    is adding files and BENCHMARK.json entries: the catalog finds them."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "portbench"
    cfg = json.loads((bench / "configs" / "laplace2d-724.json").read_text())
    cfg.update(name="laplace2d-300", args={"nx": 300})
    (bench / "configs" / "laplace2d-300.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "eigh-la-k5-m80.json").read_text())
    tr["args"]["which"], tr["want"]["want"] = "SA", "SA"
    (bench / "traffic" / "eigh-sa-k5-m80.json").write_text(json.dumps(tr))
    wl = {"config": "laplace2d-300", "traffic": "eigh-sa-k5-m80", "chips": 1,
          "why": "a throwaway cell",
          "limits": {"value_err": 1, "residual": 1, "orth": 1, "missing": 0}}
    (bench / "workloads" / "l2d300-eigh-sa.json").write_text(json.dumps(wl))
    (bench / "metrics" / "solver.restarts.py").write_text(
        'UNIT = "restarts"\nLAYER = "Restart drivers"\nMOVES = "solve_s"\n'
        'SOURCE = "program_counter"\nBETTER = "lower"\nSPANS = {}\n\n\n'
        'def read(run):\n    return None\n')
    spec["configs"].append({"name": "laplace2d-300", "source": "x",
                            "file": "portbench/configs/laplace2d-300.json",
                            "reduced": ["nx"], "why": "x"})
    spec["workloads"].append({"name": "l2d300-eigh-sa", "config": "laplace2d-300",
                              "traffic": "eigh-sa-k5-m80", "chips": 1, "why": "x"})
    next(m for m in spec["end_to_end"] if m["name"] == "peak_mem_gib")["workloads"].append(
        "l2d300-eigh-sa")
    spec["per_layer"].append({"name": "solver.restarts", "unit": "restarts",
                              "better": "lower", "source": "program_counter",
                              "layer": "Restart drivers", "moves": "solve_s",
                              "workloads": ["l2d300-eigh-sa"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cat = Catalog(tmp_path)
    assert "l2d300-eigh-sa" in cat.names("workloads")
    assert cat.config(cat.workload("l2d300-eigh-sa")["config"])["args"] == {"nx": 300}
    assert cat.metric("solver.restarts").read(None) is None
    assert [m["name"] for m in cat.cell_metrics("l2d300-eigh-sa", "per_layer")] == [
        "solver.restarts"]
    assert [m["name"] for m in cat.cell_metrics("l2d300-eigh-sa", "end_to_end")] == [
        "setup_s", "solve_s", "peak_mem_gib"]


def test_a_target_that_is_gone_resolves_to_none():
    assert resolve("arnoldi_tpu_torch.ops.ortho:ORTHO_KERNELS[no_such]") is None
    assert resolve("arnoldi_tpu_torch.linop:NoSuchClass.matvec") is None
    assert resolve("no_such_package.mod:fn") is None


def test_every_solve_starts_from_its_seed_and_index():
    from portbench.harness import solve_generator

    big = 2**40 + 3
    a = [solve_generator(big, i).initial_seed() for i in range(-1, 6)]
    again = [solve_generator(big, i).initial_seed() for i in range(-1, 6)]
    other = [solve_generator(17, i).initial_seed() for i in range(-1, 6)]
    assert a == again and len(set(a)) == len(a)
    assert not set(a) & set(other)


def test_the_window_census_is_fixed_by_its_seed():
    cat = Catalog(ROOT)
    entry = cat.entry("eigsh_window")
    Z = entry._census(64, 0)
    assert Z.shape[1] == 64 and set(Z.ravel().tolist()) == {-1.0, 1.0}
    assert (entry._census(64, 0) == Z).all()
    assert (cat.entry("eigsh_window")._census(64, 0) == Z).all()   # a new process
    assert not (entry._census(64, 1) == Z).all()
    assert cat.traffic("window-60")["args"]["census_seed"] == 0
