"""The NumPy-only host modules of ``arnoldi_tpu``, loaded without JAX.

``arnoldi_tpu/__init__.py`` (and ``arnoldi_tpu/utils/__init__.py``) import
JAX, so ``import arnoldi_tpu.matrices`` fails where JAX is not installed.
The modules below import only NumPy/SciPy (and the ctypes bindings of the
native dense tier and the host-tier engine, which build their libraries with
``g++`` on first use, not on import), so they are reused as they are: each
is loaded from its file under a private package alias whose parent packages
are empty stubs with ``__path__`` pointing at the JAX package's directories.
Relative imports between them then resolve inside the alias, and no
``__init__.py`` of the JAX package runs.
"""

import importlib
import sys
import types
from pathlib import Path

_ALIAS = "arnoldi_tpu_torch._reference_host"
_ROOT = Path(__file__).resolve().parent.parent / "arnoldi_tpu"


def _stub(name, path):
    if name not in sys.modules:
        mod = types.ModuleType(name)
        mod.__path__ = [str(path)]
        sys.modules[name] = mod
    return sys.modules[name]


_stub(_ALIAS, _ROOT)
for _sub in ("ops", "utils", "native"):
    setattr(sys.modules[_ALIAS], _sub, _stub(f"{_ALIAS}.{_sub}", _ROOT / _sub))

matrices = importlib.import_module(f"{_ALIAS}.matrices")
sorting = importlib.import_module(f"{_ALIAS}.utils.sorting")
history = importlib.import_module(f"{_ALIAS}.utils.history")
dense_tier = importlib.import_module(f"{_ALIAS}.ops.dense_tier")
native_dense_tier = importlib.import_module(f"{_ALIAS}.native.dense_tier")
host_engine = importlib.import_module(f"{_ALIAS}.native.host_engine")

History = history.History

__all__ = ["History", "dense_tier", "history", "host_engine", "matrices",
           "native_dense_tier", "sorting"]
