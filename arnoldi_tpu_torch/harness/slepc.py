"""SLEPc comparison support (reference ``scripts/utils.py:190-381`` and
``scripts/compare-against-slepc.py``).

Counterpart of ``arnoldi_tpu/harness/slepc.py``, with the same guarded
import and the same ``ImportError`` text.  Activates when petsc4py and
slepc4py are installed (see the reference's ``scripts/INSTALL_SLEPC.md``
for a source build).  They are installed neither in the CPU environment
the port's tests run in nor on the H100 machine it is measured on, so only
the ``ImportError`` path has run.  Provides the CSR conversion with
COMM_WORLD row distribution, a per-iteration convergence monitor, the
``slepc_eig`` driver (KRYLOVSCHUR / NHEP / relative convergence) and
:func:`probe`.
"""

import time

import numpy as np

from .suite import EigensolverParameters, Statistics


def _import_slepc():
    try:
        from petsc4py import PETSc
        from slepc4py import SLEPc
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "petsc4py/slepc4py are not installed; the SLEPc comparison is "
            "optional (see the reference's scripts/INSTALL_SLEPC.md for a "
            "source-build recipe)"
        ) from e
    return PETSc, SLEPc


class ConvergenceTracker:
    """EPS monitor storing (iteration, nconv, eigenvalues, errors) per
    iteration and printing every 100 iterations
    (reference ``scripts/utils.py:190-209``)."""

    def __init__(self, print_every=100):
        self.history = []
        self.print_every = print_every

    def __call__(self, eps, its, nconv, eig, err):
        self.history.append((its, nconv, list(eig[:nconv + 1]),
                             list(err[:nconv + 1])))
        if self.print_every and its % self.print_every == 0:
            print(f"  SLEPc iter {its}: nconv={nconv}")


def scipy_csr_to_petsc(A, comm=None):
    """Distribute a SciPy CSR matrix over a PETSc communicator by row blocks
    (reference ``scripts/utils.py:212-235``)."""
    PETSc, _ = _import_slepc()
    comm = comm or PETSc.COMM_WORLD
    n = A.shape[0]
    M = PETSc.Mat()
    M.create(comm)
    M.setSizes([n, n])
    M.setType(PETSc.Mat.Type.AIJ)
    M.setUp()
    rstart, rend = M.getOwnershipRange()
    csr = A.tocsr()
    for i in range(rstart, rend):
        cols = csr.indices[csr.indptr[i]:csr.indptr[i + 1]]
        vals = csr.data[csr.indptr[i]:csr.indptr[i + 1]]
        M.setValues(i, cols, vals)
    M.assemble()
    return M


def slepc_eig(A, params: EigensolverParameters, monitor=None):
    """Solve with SLEPc Krylov-Schur (reference ``scripts/utils.py:352-381``)."""
    PETSc, SLEPc = _import_slepc()
    M = scipy_csr_to_petsc(A)

    eps = SLEPc.EPS().create()
    eps.setOperators(M)
    eps.setProblemType(SLEPc.EPS.ProblemType.NHEP)
    eps.setType(SLEPc.EPS.Type.KRYLOVSCHUR)
    which_map = {
        "LM": SLEPc.EPS.Which.LARGEST_MAGNITUDE,
        "LR": SLEPc.EPS.Which.LARGEST_REAL,
        "SM": SLEPc.EPS.Which.SMALLEST_MAGNITUDE,
        "SR": SLEPc.EPS.Which.SMALLEST_REAL,
    }
    eps.setWhichEigenpairs(which_map[params.which])
    eps.setDimensions(params.nev, params.ncv or PETSc.DECIDE)
    eps.setTolerances(params.tol, params.max_restarts)
    eps.setConvergenceTest(SLEPc.EPS.Conv.REL)
    if monitor is not None:
        eps.setMonitor(monitor)
    eps.setFromOptions()

    t0 = time.perf_counter()
    eps.solve()
    elapsed = time.perf_counter() - t0

    nconv = eps.getConverged()
    n = A.shape[0]
    vals = np.zeros(min(nconv, params.nev), dtype=np.complex128)
    vecs = np.zeros((n, len(vals)), dtype=np.complex128)
    vr, vi = M.createVecs()
    for i in range(len(vals)):
        lam = eps.getEigenpair(i, vr, vi)
        vals[i] = lam
        vecs[:, i] = vr.getArray() + 1j * vi.getArray()
    stats = Statistics(elapsed, "complex128", -1, eps.getIterationNumber())
    return vals, vecs, stats


def probe(path=None):
    """Whether the SLEPc comparison can run here: installed (with the
    petsc4py version) or blocked (with the reason and whether an MPI
    compiler wrapper is present), as JSON in ``path`` when given."""
    import json
    import shutil
    import sys

    status = {"leg": "slepc", "python": sys.version.split()[0]}
    try:
        from petsc4py import PETSc  # noqa: F401
        from slepc4py import SLEPc  # noqa: F401

        status["status"] = "available"
        status["petsc4py"] = getattr(PETSc, "__version__", "?")
    except ImportError as e:
        status.update({
            "status": "blocked",
            "reason": str(e).split(";")[0],
            "mpicc": shutil.which("mpicc"),
            "note": "petsc4py/slepc4py absent: harness/slepc.py and "
                    "harness/compare_slepc.py cannot run; only their "
                    "ImportError path is tested.",
        })
    if path:
        with open(path, "w") as f:
            json.dump(status, f, indent=2)
    return status


if __name__ == "__main__":
    import json as _json
    import sys as _sys

    out = _sys.argv[1] if len(_sys.argv) > 1 else None
    print(_json.dumps(probe(out), indent=2))
