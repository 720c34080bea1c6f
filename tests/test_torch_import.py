"""``arnoldi_tpu_torch`` imports and solves (``partial_schur`` scalar, block
over BSR-8, on the host tier and refined from float32; ``partial_eigh`` on
both loops and on the host tier; ``svds`` over a Gram with its adjoint
leg; ``eigsh`` with a cg shift-invert inner solve and ``svds(sigma=)``;
``eigsh_filtered``, ``eigsh_window``, both explicit-restart drivers, and
``parallel``'s sharded solve and ring-halo operator on a one-rank mesh)
where JAX cannot be imported, a CPU solve never builds or loads
the CUDA kernel library, and nothing is loaded from the JAX package's tree:
no module and no shared library (the port's own host libraries build under
``build/arnoldi_tpu_torch/``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = """
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import arnoldi_tpu_torch
from arnoldi_tpu_torch import partial_eigh, partial_schur
from arnoldi_tpu_torch import matrices
from arnoldi_tpu_torch.ops import kernels
from arnoldi_tpu_torch.ops.kernels import _build
from arnoldi_tpu_torch.solvers import refine, svd
from arnoldi_tpu_torch.solvers.workspace import uses_host_tier
A = matrices.mark(12)
assert uses_host_tier(A, device="cpu")
Q, T, hist = partial_schur(A, 3, sort_function="LR", device="cpu")
res = np.linalg.norm(A @ Q.numpy() - Q.numpy() @ T.numpy(), axis=0).max()
op = arnoldi_tpu_torch.as_operator(A, format="bsr", device="cpu")
Q, T, hist = partial_schur(op, 3, sort_function="LR", block_size=2)
res = max(res, np.linalg.norm(A @ Q.numpy() - Q.numpy() @ T.numpy(), axis=0).max())
S = matrices.laplace_2d(12, 11)
solves = [partial_eigh(S, 3, device="cpu"),                     # host tier
          partial_eigh(arnoldi_tpu_torch.as_operator(S, device="cpu"), 3),
          partial_eigh(arnoldi_tpu_torch.as_operator(S, device="cpu"), 3,
                       device_loop=False, ortho="selective")]
for vals, vecs, _ in solves:
    V = vecs.numpy()
    res = max(res, np.linalg.norm(S @ V - V * vals, axis=0).max())
Q, T, hist = partial_schur(arnoldi_tpu_torch.as_operator(A, device="cpu"), 3,
                           sort_function="LR", dtype=np.float32,
                           stopping_criterion=1e-8)          # refined
assert Q.dtype == torch.float64
res = max(res, np.linalg.norm(A @ Q.numpy() - Q.numpy() @ T.numpy(), axis=0).max())
R = A[:, :40]
U, s, Vh = arnoldi_tpu_torch.svds(R, 2, device="cpu")
res = max(res, np.abs(R @ Vh.numpy().T - U.numpy() * s).max())
from arnoldi_tpu_torch.solvers import inner, spectral_transform
L = matrices.laplace(60).tocsr()
vals, vecs = arnoldi_tpu_torch.eigsh(L, 3, sigma=-0.5, inner_solver="cg",
                                     tol=1e-9, device="cpu")
V = vecs.numpy()
res = max(res, np.linalg.norm(L @ V - V * vals, axis=0).max())
U, s, Vh = arnoldi_tpu_torch.svds(R, 2, sigma=0.5, tol=1e-9, device="cpu")
res = max(res, np.abs(R @ Vh.numpy().T - U.numpy() * s).max())
from arnoldi_tpu_torch.solvers import explicit_restarts, filtered
L = matrices.laplace(120).tocsr()
for vals, vecs, _ in (
        arnoldi_tpu_torch.eigsh_filtered(L, 3, (-2.1, -1.9), tol=1e-9,
                                         device="cpu"),
        arnoldi_tpu_torch.eigsh_window(L, (-2.1, -1.9), tol=1e-9,
                                       device="cpu")):
    V = vecs.numpy()
    res = max(res, np.linalg.norm(L @ V - V * vals, axis=0).max())
vals, vecs, _ = arnoldi_tpu_torch.explicit_restarts_with_deflation(
    A, 2, stopping_criterion=1e-9, device="cpu")
V = vecs.numpy()
res = max(res, np.linalg.norm(A @ V - V * vals, axis=0).max())
ritz, converged, _ = arnoldi_tpu_torch.naive_explicit_restarts(
    A, stopping_criterion=1e-9, max_restarts=100, device="cpu")
from arnoldi_tpu_torch import parallel
from arnoldi_tpu_torch.parallel import multihost
multihost.initialize()                       # one process: a no-op
mesh = parallel.make_mesh(device="cpu")
Q, T, hist = parallel.sharded_partial_schur(
    arnoldi_tpu_torch.as_operator(A, device="cpu"), 3, mesh=mesh,
    sort_function="LR")
res = max(res, np.linalg.norm(A @ Q.numpy() - Q.numpy() @ T.numpy(), axis=0).max())
L = matrices.laplace(120).tocsr()
vals, vecs, _ = arnoldi_tpu_torch.partial_eigh(
    parallel.halo_matvec_closure(arnoldi_tpu_torch.as_operator(L, device="cpu"),
                                 mesh), 3, stopping_criterion=1e-9)
V = vecs.numpy()
res = max(res, np.linalg.norm(L @ V - V * vals, axis=0).max())
assert converged and arnoldi_tpu_torch.__version__
print(json.dumps({
    "residual": float(res),
    "jax_modules": sorted(m for m, mod in sys.modules.items()
                          if mod is not None and (
                              m == "jax" or m.startswith(("jax.", "jaxlib")))),
    "reference_package_imported": "arnoldi_tpu" in sys.modules,
    "kernel_library_loaded": _build.is_loaded(),
    "launches": kernels.launch_counts(),
    "module_files": sorted(str(getattr(mod, "__file__", None) or "")
                           for mod in list(sys.modules.values())
                           if mod is not None),
    "shared_libraries": sorted({line.split()[-1]
                                for line in open("/proc/self/maps")
                                if ".so" in line.split()[-1]}),
}))
"""


def test_imports_and_solves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["residual"] < 1e-6
    assert out["jax_modules"] == []
    assert not out["reference_package_imported"]
    assert not out["kernel_library_loaded"]
    assert set(out["launches"].values()) == {0}
    reference = REPO / "arnoldi_tpu"
    assert [f for f in out["module_files"]
            if Path(f).is_relative_to(reference)] == []
    assert [lib for lib in out["shared_libraries"]
            if Path(lib).is_relative_to(reference)] == []
    # the host-tier solve ran the port's own C++ libraries, built outside
    # the source tree
    built = {Path(lib).name: Path(lib).parent for lib in out["shared_libraries"]
             if Path(lib).name in ("libdense_tier.so", "libhost_engine.so")}
    assert built == {"libdense_tier.so": REPO / "build" / "arnoldi_tpu_torch",
                     "libhost_engine.so": REPO / "build" / "arnoldi_tpu_torch"}


_HARNESS_SCRIPT = """
import importlib, importlib.util, json, sys
from pathlib import Path
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["arnoldi_tpu"] = None  # and so does the JAX package
names = ["suite", "bench_partial_schur", "compare_arpack", "stress_test",
         "scaling_bench", "plot_stress", "slepc", "compare_slepc"]
for name in names:
    importlib.import_module("arnoldi_tpu_torch.harness." + name)
import arnoldi_tpu_torch.harness
examples = sorted(Path("examples/torch").glob("*.py"))
for path in examples:             # import, not run: main() is guarded
    spec = importlib.util.spec_from_file_location("example_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({
    "examples": len(examples),
    "modules": sorted(m for m, mod in sys.modules.items() if mod is not None
                      and (m == "jax" or m.startswith(("jax.", "jaxlib"))
                           or m == "arnoldi_tpu"
                           or m.startswith("arnoldi_tpu.")))}))
"""


def test_harness_and_examples_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _HARNESS_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["examples"] == 6
    assert out["modules"] == []
