"""The numbers that decide ``correct``: a solve's eigenpairs against the
exact spectrum of the reference's own operator.

A judge is built once per cell from the configuration (the grid) and the
traffic's ``want`` (which eigenvalues a solve has to return) and reads the
answers a solve returned, as host float64 arrays:

* ``value_err``: the largest distance of a returned eigenvalue from the
  exact eigenvalue it stands for, over the spectral radius.  A window is
  compared value for value, sorted, when the counts agree; otherwise, and
  for the Krylov wants, each value against its nearest exact one.
* ``residual``: the largest ``||A v - lambda v||`` (Schur form: a column of
  ``A Q - Q T``) over the spectral radius, ``A`` the reference's stencil.
* ``orth``: the largest ``|V^T V - I|`` entry; in a window only between
  vectors whose values stand for one exact eigenvalue (vectors of
  different eigenvalues are held apart by ``residual`` and ``value_err``:
  ``|<v_i, v_j>| <= (||r_i|| + ||r_j||) / |lambda_i - lambda_j|``).
* ``missing``: exact, limit 0.  Krylov wants: the returned count short of
  ``k``, plus every distinct exact eigenvalue more wanted than the least
  wanted one returned that no returned value stands for (a scalar Krylov
  space may hold one copy of a double eigenvalue, never skip one).  A
  window: the difference between the returned and the exact count.

:func:`cell_judge` picks the judge of a cell: this one where the
configuration's generator is a grid Laplacian, else
:class:`.sparse.SparseJudge` on the configuration's stored spectrum.
"""

import numpy as np

from .stencil import Grid

#: Exact eigenvalues closer than this share of the spectral radius are one
#: eigenvalue (the closed form rounds copies of a multiple one apart).
CLUSTER_TOL = 1e-12

NUMBERS = ("value_err", "residual", "orth", "missing")

#: The generators whose spectrum :class:`.stencil.Grid` knows in closed form.
GRID_GENERATORS = ("laplace_2d", "laplace_3d")


def want_key(want):
    """Sort key of a Krylov want: smaller is more wanted."""
    kind = want["want"]
    if kind == "LM":
        return lambda lam: -np.abs(lam)
    if kind in ("LA", "LR"):
        return lambda lam: -np.real(lam)
    if kind in ("SA", "SR"):
        return lambda lam: np.real(lam)
    if kind == "nearest":
        sigma = float(want["sigma"])
        return lambda lam: np.abs(lam - sigma)
    raise ValueError(f"unknown want {kind!r}")


class Judge:
    """Judges the answers of one cell's solves (see the module doc)."""

    def __init__(self, config, want):
        self.grid = Grid(config["generator"], config["args"])
        self.want = want
        vals, modes = self.grid.spectrum()
        self.exact, self.modes = vals, modes
        self.scale = float(max(abs(vals[0]), abs(vals[-1])))
        # cluster id of each exact value, and each cluster's value
        self.cluster = np.concatenate(
            [[0], np.cumsum(np.diff(vals) > CLUSTER_TOL * self.scale)])
        first = np.concatenate([[0], np.nonzero(np.diff(self.cluster))[0] + 1])
        self.cluster_value = vals[first]

    # -- which exact pairs a solve has to return -------------------------
    def wanted(self):
        """Indices (into the exact spectrum) of the pairs a solve has to
        return: the ``k`` most wanted, or every one inside the window."""
        if self.want["want"] == "window":
            a, b = self.want["interval"]
            return np.nonzero((self.exact >= a) & (self.exact <= b))[0]
        key = want_key(self.want)(self.exact)
        return np.argsort(key, kind="stable")[: int(self.want["k"])]

    def _nearest_cluster(self, lam):
        cv = self.cluster_value
        idx = np.clip(np.searchsorted(cv, np.real(lam)), 1, cv.size - 1)
        left = np.abs(cv[idx - 1] - lam) <= np.abs(cv[idx] - lam)
        return np.where(left, idx - 1, idx)

    # -- the numbers -------------------------------------------------------
    def numbers(self, answer):
        """``{name: value}`` of :data:`NUMBERS` for one answer: a dict with
        ``values`` ((k,) real or complex) and ``vectors`` ((n, k)), or
        ``Q`` and ``T`` (a Schur form)."""
        if "T" in answer:
            V = np.asarray(answer["Q"], dtype=np.float64)
            T = np.asarray(answer["T"], dtype=np.float64)
            lam = np.linalg.eigvals(T) if T.size else np.empty(0)
            R = self.grid.apply(V) - V @ T
        else:
            V = np.asarray(answer["vectors"], dtype=np.float64)
            lam = np.asarray(answer["values"])
            R = self.grid.apply(V) - V * np.real(lam)[None, :]
        k = lam.size
        out = {"value_err": 0.0, "residual": 0.0, "orth": 0.0, "missing": 0}
        if V.shape != (self.grid.n, k):
            raise ValueError(f"vectors {V.shape} for {k} values on n = "
                             f"{self.grid.n}")
        if k:
            out["residual"] = float(np.linalg.norm(R, axis=0).max() / self.scale)
        near = self._nearest_cluster(lam) if k else np.empty(0, int)
        if k:
            out["value_err"] = float(
                np.abs(lam - self.cluster_value[near]).max() / self.scale)
        G = V.T @ V - np.eye(k)
        if self.want["want"] == "window":
            want_vals = self.exact[self.wanted()]
            out["missing"] = abs(k - want_vals.size)
            if k and k == want_vals.size:
                out["value_err"] = float(
                    np.abs(np.sort(np.real(lam)) - want_vals).max() / self.scale)
            same = near[:, None] == near[None, :]
            out["orth"] = float(np.abs(G[same]).max()) if k else 0.0
        else:
            out["orth"] = float(np.abs(G).max()) if k else 0.0
            short = max(0, int(self.want["k"]) - k)
            skipped = 0
            if k:
                key = want_key(self.want)
                cluster_keys = key(self.cluster_value)
                worst = cluster_keys[near].max()
                ahead = np.nonzero(cluster_keys < worst
                                   - CLUSTER_TOL * self.scale)[0]
                skipped = int(np.setdiff1d(ahead, near).size)
            out["missing"] = short + skipped
        return out


def cell_judge(catalog, cell):
    """The judge of ``cell`` (its ``workloads/<cell>.json``) in ``catalog``."""
    config = catalog.config(cell["config"])
    want = catalog.traffic(cell["traffic"])["want"]
    if config["generator"] in GRID_GENERATORS:
        return Judge(config, want)
    from .sparse import SparseJudge

    return SparseJudge(config, want, catalog.spectrum(cell["config"]))


def worst(readings):
    """The largest of each number over several answers' readings."""
    if not readings:
        return {}
    return {name: max(r[name] for r in readings) for name in readings[0]}


def verdict(numbers, limits):
    """``(ok, checks)``: ``checks[name] = {"value": ..., "limit": ...}``;
    ``ok`` when every number is finite and at most its limit."""
    checks = {}
    ok = True
    for name in NUMBERS:
        if name not in numbers:
            continue
        value, limit = numbers[name], limits[name]
        checks[name] = {"value": value, "limit": limit}
        if not (np.isfinite(value) and value <= limit):
            ok = False
    return ok, checks
