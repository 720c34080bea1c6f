"""Finding the benchmark's parts by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under the benchmark's folder,
named after it:

* ``configs/<config>.json``: the matrix (generator and arguments), its
  storage format and dtype, ``source``, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the entry point of the program, its
  arguments, the warm-up's changes to them, and ``want`` (which pairs a
  solve has to return, for the reference);
* ``workloads/<cell>.json``: the configuration, the traffic, ``chips``,
  ``why``, the limits of the comparison and how many solves a traced run
  profiles;
* ``metrics/<metric>.py``: a per-layer metric's spans and reader;
* ``entries/<entry>.py``: how to call one entry point of the program;
* ``spectra/<config>.json``: the stored spectrum of a configuration whose
  matrix has no closed form (written by ``reference/spectrum.py``).

``BENCHMARK.json`` at the root of the checkout lists the cells and
metrics; which per-layer metrics a cell reports follows from it.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(path, mod_name):
    """The Python file ``path`` run as a module named ``mod_name``."""
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Catalog:
    """The benchmark under ``root`` (the checkout) and its folder
    ``bench`` (default ``root/portbench``)."""

    def __init__(self, root=None, bench=None):
        self.root = Path(root) if root is not None else HERE.parent
        self.bench = Path(bench) if bench is not None else self.root / HERE.name
        self._spec = None

    def _json(self, *parts):
        path = self.bench.joinpath(*parts)
        if not path.is_file():
            raise FileNotFoundError(f"no {path.relative_to(self.root)}")
        with open(path) as f:
            return json.load(f)

    @property
    def spec(self):
        """``BENCHMARK.json``."""
        if self._spec is None:
            with open(self.root / "BENCHMARK.json") as f:
                self._spec = json.load(f)
        return self._spec

    def names(self, kind):
        """The names of every file of a kind: ``configs``, ``traffic``,
        ``workloads`` (JSON) or ``metrics``, ``entries`` (Python)."""
        suffix = ".py" if kind in ("metrics", "entries") else ".json"
        return sorted(p.name[: -len(suffix)] for p in (self.bench / kind).glob("*" + suffix)
                      if not p.name.startswith("_"))

    def workload(self, name):
        return self._json("workloads", name + ".json")

    def config(self, name):
        return self._json("configs", name + ".json")

    def traffic(self, name):
        return self._json("traffic", name + ".json")

    def spectrum(self, name):
        return self._json("spectra", name + ".json")

    def _module(self, kind, name):
        path = self.bench / kind / (name + ".py")
        if not path.is_file():
            raise FileNotFoundError(f"no {path.relative_to(self.root)}")
        return load(path, f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"))

    def metric(self, name):
        return self._module("metrics", name)

    def entry(self, name):
        return self._module("entries", name)

    def cell_metrics(self, cell, section):
        """The ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json
        that ``cell`` reports: those that list it under ``workloads``, and
        those without the key (a per-layer one only where the cell reports
        the end-to-end metric it moves)."""
        spec = self.spec
        reported = [m["name"] for m in spec["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        out = []
        for m in spec[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in reported:
                out.append(m)
        return out
