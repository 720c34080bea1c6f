"""The reference of a matrix that has no closed-form spectrum.

The operator is the configuration's matrix from the benchmark's frozen
generator, on the host in float64 (complex128 for a complex one), applied
by SciPy: nothing of the program.  Its wanted eigenvalues are read from
``spectra/<config>.json``, which ``reference/spectrum.py`` writes with a
solver independent of the program (:func:`pairs`): dense LAPACK up to
:data:`DENSE_MAX` rows, SciPy's ARPACK beyond, each value with its
residual, and the spectral radius that scales the numbers.

:class:`SparseJudge` reads a solve's answers as :class:`.judge.Judge` does
and gives the same numbers, in the complex plane:

* ``value_err``: the largest distance of a returned eigenvalue from the
  nearest stored one, over the spectral radius;
* ``residual``: the largest ``||A v - lambda v||`` (Schur form: a column
  of ``A Q - Q T``) over the radius;
* ``orth``: the largest ``|V^H V - I|`` entry: over every column of a
  Schur form; between eigenvectors only where they stand for one stored
  eigenvalue (a non-normal matrix's eigenvectors are not orthogonal);
* ``missing``: the returned count short of ``k``, plus every distinct
  stored eigenvalue more wanted than the least wanted one returned that
  no returned value stands for.

Stored values closer than ``CLUSTER_TOL`` of the radius are one
eigenvalue.  The control and the planted faults (:mod:`.control`) start
from :meth:`SparseJudge.exact_answer`, the independent solver's pairs.
"""

import numpy as np

from .. import generators
from .judge import CLUSTER_TOL, want_key

#: Up to this many rows the spectrum is dense LAPACK's, beyond ARPACK's.
DENSE_MAX = 8000
#: ARPACK's tolerance on the wanted values, and its least Krylov dimension
#: (mark(1000)'s 15 largest real values lie within 1e-3 of each other).
TOL = 1e-13
NCV = 100
#: ARPACK's tolerance on the spectral radius.  The radius only scales the
#: numbers, and the limits are set from readings on the same stored value;
#: at 1e-6 it took 798 s on 3 CPU threads for mark(1000), whose four
#: largest moduli lie within 5e-6 of each other.
RADIUS_TOL = 1e-3
#: The largest residual over the radius a stored value may have.
RESIDUAL_MAX = 1e-12
#: Stored values a want needs beyond the ``k`` a solve returns.
MARGIN = 10


def operator(config):
    """The configuration's matrix as host CSR, float64 or complex128."""
    A = generators.build(config).tocsr()
    return A.astype(np.complex128 if np.iscomplexobj(A.data) else np.float64)


def matrix_record(config, A):
    """What a spectrum file records of the matrix it was computed for."""
    return {"generator": config["generator"], "args": config["args"],
            "dtype": config["dtype"], "n": int(A.shape[0]), "nnz": int(A.nnz)}


def want_label(want):
    """The key of a want in a spectrum file: ``LR``, ``nearest:0.01``."""
    kind = want["want"]
    if kind == "window":
        raise ValueError("a stored spectrum holds Krylov wants, not windows")
    return f"nearest:{float(want['sigma'])!r}" if kind == "nearest" else kind


def _hermitian(A):
    D = A - A.conj().T
    return D.nnz == 0 or not np.any(D.data)


def _arpack(A, want, k, v0, tol=TOL):
    from scipy.sparse.linalg import eigs, eigsh

    hermitian = _hermitian(A)
    kind = want["want"]
    args = {"k": k, "tol": tol, "ncv": min(A.shape[0] - 1, max(2 * k + 1, NCV)),
            "maxiter": 100 * A.shape[0]}
    if kind == "nearest":
        args.update(sigma=float(want["sigma"]), which="LM")
    elif hermitian:
        args["which"] = {"LM": "LM", "LA": "LA", "LR": "LA", "SA": "SA", "SR": "SA"}[kind]
    else:
        args["which"] = {"LM": "LM", "LA": "LR", "LR": "LR", "SA": "SR", "SR": "SR"}[kind]
    fn = eigsh if hermitian else eigs
    vals, vecs = fn(A, v0=v0, **args)
    return vals, vecs, {"solver": f"scipy.sparse.linalg.{fn.__name__}", "args": args}


def pairs(A, want, k, radius=True):
    """The ``k`` most wanted eigenpairs of ``A``, most wanted first, by a
    solver independent of the program: ``(values, unit vectors, how,
    (radius, how) or None)``; real arrays where ``A`` and the values are
    real.  The spectral radius, where asked, comes from every eigenvalue
    (dense) or an ARPACK ``LM`` solve at :data:`RADIUS_TOL`."""
    n = A.shape[0]
    v0 = np.random.default_rng(0).standard_normal(n).astype(A.dtype)
    rad = None
    if n <= DENSE_MAX:
        vals, vecs = np.linalg.eig(A.toarray())
        how = {"solver": "numpy.linalg.eig", "args": {}}
        rad = float(np.abs(vals).max()), how
    else:
        vals, vecs, how = _arpack(A, want, k, v0)
        if radius:
            lm, _, lm_how = _arpack(A, {"want": "LM"}, 2, v0, RADIUS_TOL)
            rad = float(np.abs(lm).max()), lm_how
    order = np.argsort(want_key(want)(vals), kind="stable")[:k]
    vals, vecs = vals[order], vecs[:, order]
    vecs = vecs / np.linalg.norm(vecs, axis=0)
    if not np.iscomplexobj(A.data) and np.iscomplexobj(vals) and not np.any(vals.imag):
        vals, vecs = vals.real, vecs.real     # real eigenvalues of a real matrix
    return vals, vecs, how, (rad if radius else None)


def residuals(A, values, vectors, radius):
    """``||A v - lambda v|| / radius`` of each unit-vector pair."""
    return np.linalg.norm(A @ vectors - vectors * values[None, :], axis=0) / radius


class SparseJudge:
    """Judges the answers of one cell's solves on a stored spectrum (see
    the module doc): ``config`` the configuration, ``want`` the traffic's,
    ``spectrum`` the configuration's ``spectra/<config>.json``."""

    def __init__(self, config, want, spectrum):
        self.A = operator(config)
        self.n = self.A.shape[0]
        self.want = want
        if spectrum["matrix"] != matrix_record(config, self.A):
            raise ValueError(f"the spectrum of {spectrum['config']!r} was computed "
                             f"for {spectrum['matrix']}, not this configuration")
        label = want_label(want)
        if label not in spectrum["wants"]:
            raise ValueError(f"the spectrum of {spectrum['config']!r} holds no "
                             f"want {label!r}: {sorted(spectrum['wants'])}")
        stored = spectrum["wants"][label]
        vals = np.array([complex(re, im) for re, im in stored["values"]])
        if vals.size < int(want["k"]) + MARGIN:
            raise ValueError(f"the spectrum of {spectrum['config']!r} holds "
                             f"{vals.size} values of {label!r}; a solve of k = "
                             f"{want['k']} needs k + {MARGIN}")
        self.scale = float(spectrum["radius"])
        # a stored value within CLUSTER_TOL of a more wanted cluster's
        # value is a copy of it
        first = []
        for lam in vals[np.argsort(want_key(want)(vals), kind="stable")]:
            if not any(abs(lam - c) <= CLUSTER_TOL * self.scale for c in first):
                first.append(lam)
        self.cluster_value = np.array(first)
        self._exact = None

    def apply(self, V):
        """``A @ V`` for an ``(n, k)`` block."""
        return self.A @ V

    def exact_answer(self):
        """The independent solver's ``k`` wanted pairs in float64 (or
        complex128): ``(values, unit vectors)``, most wanted first."""
        if self._exact is None:
            vals, vecs, _, _ = pairs(self.A, self.want, int(self.want["k"]), radius=False)
            self._exact = vals, vecs
        return self._exact

    def _nearest_cluster(self, lam):
        return np.abs(lam[:, None] - self.cluster_value[None, :]).argmin(axis=1)

    def numbers(self, answer):
        """``{name: value}`` of the judge's numbers for one answer: a dict
        with ``values`` ((k,)) and ``vectors`` ((n, k)), or ``Q`` and ``T``
        (a Schur form); complex answers stay complex."""
        def wide(x):
            x = np.asarray(x)
            return x.astype(np.result_type(x.dtype, np.float64))

        schur = "T" in answer
        if schur:
            V, T = wide(answer["Q"]), wide(answer["T"])
            lam = np.linalg.eigvals(T) if T.size else np.empty(0)
        else:
            V, lam = wide(answer["vectors"]), wide(answer["values"])
        k = lam.size
        if V.shape != (self.n, k):
            raise ValueError(f"vectors {V.shape} for {k} values on n = {self.n}")
        out = {"value_err": 0.0, "residual": 0.0, "orth": 0.0, "missing": 0}
        short = max(0, int(self.want["k"]) - k)
        if not k:
            out["missing"] = short
            return out
        R = self.apply(V) - (V @ T if schur else V * lam[None, :])
        out["residual"] = float(np.linalg.norm(R, axis=0).max() / self.scale)
        near = self._nearest_cluster(lam)
        out["value_err"] = float(np.abs(lam - self.cluster_value[near]).max() / self.scale)
        G = np.abs(V.conj().T @ V - np.eye(k))
        out["orth"] = float(G.max() if schur else G[near[:, None] == near[None, :]].max())
        keys = want_key(self.want)(self.cluster_value)
        ahead = np.nonzero(keys < keys[near].max() - CLUSTER_TOL * self.scale)[0]
        out["missing"] = short + int(np.setdiff1d(ahead, near).size)
        return out
