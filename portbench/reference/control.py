"""The control and the planted faults, each put in the program's place.

:func:`control_answer` is the reference's own answer computed in float32,
the nearest precision below the configurations' float64: the exact wanted
eigenpairs from the closed form, evaluated in float32, a seeded rotation
within each multiple eigenvalue.  It is the best answer any float32
computation could give, so limits that reject it reject a float32 solve.

:func:`fault_answer` plants, on the float64 exact answer, the faults a run
of these cells can have: ``unchanged`` (the solve returns its start state:
seeded orthonormal vectors with their Rayleigh quotients), ``half`` (half
of the wanted pairs left out) and ``altered`` (one returned value moved by
1e-6 of the spectral radius where it is produced).  One chip, so there is
no exchange between chips to leave out.

On a stored spectrum (:class:`.sparse.SparseJudge`) the exact answer is
the independent solver's float64 pairs, and a Schur form is ``Q`` from the
QR of their eigenvectors with ``T = Q^H A Q``.  The control is that answer
rounded to float32 (complex64), the same on every seed; the faults are
planted on it as above, the altered value at ``T[0, 0]`` of a Schur form.
"""

import numpy as np

from .sparse import SparseJudge

FAULTS = ("unchanged", "half", "altered")


def _exact_answer(judge, dtype, rng):
    """The wanted exact pairs in ``dtype``: ``(values, vectors)``, vectors
    of one multiple eigenvalue rotated by a random orthogonal matrix."""
    idx = judge.wanted()
    modes = judge.modes
    values = np.array([_mode_value(judge.grid, modes[i], dtype) for i in idx],
                      dtype=dtype)
    V = np.stack([judge.grid.eigenvector(modes[i], dtype) for i in idx], axis=1)
    clusters = judge.cluster[idx]
    for c in np.unique(clusters):
        cols = np.nonzero(clusters == c)[0]
        if cols.size > 1:
            Qr, _ = np.linalg.qr(rng.standard_normal((cols.size, cols.size)))
            V[:, cols] = (V[:, cols] @ Qr.astype(dtype)).astype(dtype)
    return values, V


def _mode_value(grid, mode, dtype):
    """One eigenvalue from its mode tuple, in ``dtype`` arithmetic."""
    total = dtype(0)
    for m, k in zip(grid.shape, mode):
        total = total + (dtype(-2) + dtype(2) * np.cos(
            dtype(k) * dtype(np.pi) / dtype(m + 1)))
    return total


def _as_kind(kind, values, V):
    if kind == "schur":
        return {"Q": V, "T": np.diag(values)}
    return {"values": values, "vectors": V}


def _stored_answer(judge, kind, values, V):
    """Pairs on a stored spectrum as a solve of ``kind`` returns them."""
    if kind == "schur":
        Q = np.linalg.qr(V)[0]
        return {"Q": Q, "T": Q.conj().T @ judge.apply(Q)}
    return {"values": values, "vectors": V}


def _rounded(x):
    """``x`` rounded to float32 (complex64) and widened again."""
    low = np.complex64 if np.iscomplexobj(x) else np.float32
    return x.astype(low).astype(x.dtype)


def _stored_fault(judge, kind, fault, rng):
    values, V = judge.exact_answer()
    if fault == "unchanged":
        W, _ = np.linalg.qr(rng.standard_normal(V.shape))
        AW = judge.apply(W)
        if kind == "schur":
            return {"Q": W, "T": W.conj().T @ AW}
        return {"values": np.einsum("ij,ij->j", W.conj(), AW), "vectors": W}
    answer = _stored_answer(judge, kind, values, V)
    if fault == "half":
        keep = values.size // 2
        if kind == "schur":
            return {"Q": answer["Q"][:, :keep], "T": answer["T"][:keep, :keep]}
        return {"values": values[:keep], "vectors": V[:, :keep]}
    if fault == "altered":
        name = "T" if kind == "schur" else "values"
        answer[name] = answer[name].copy()
        answer[name].flat[0] += 1e-6 * judge.scale
        return answer
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")


def control_answer(judge, kind, seed):
    """The control: the exact wanted pairs computed in float32, handed to
    the judge as float64 arrays, as a solve of ``kind`` returns them."""
    if isinstance(judge, SparseJudge):
        exact = _stored_answer(judge, kind, *judge.exact_answer())
        return {name: _rounded(x) for name, x in exact.items()}
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), 7]))
    values, V = _exact_answer(judge, np.float32, rng)
    return _as_kind(kind, values.astype(np.float64), V.astype(np.float64))


def fault_answer(judge, kind, fault, seed):
    """The float64 exact answer with ``fault`` (one of :data:`FAULTS`)."""
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), 11]))
    if isinstance(judge, SparseJudge):
        return _stored_fault(judge, kind, fault, rng)
    values, V = _exact_answer(judge, np.float64, rng)
    if fault == "unchanged":
        V, _ = np.linalg.qr(rng.standard_normal(V.shape))
        AV = judge.grid.apply(V)
        if kind == "schur":
            return {"Q": V, "T": V.T @ AV}
        values = np.einsum("ij,ij->j", V, AV)
    elif fault == "half":
        keep = values.size // 2
        values, V = values[:keep], V[:, :keep]
    elif fault == "altered":
        values = values.copy()
        values[0] += 1e-6 * judge.scale
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    return _as_kind(kind, values, V)
