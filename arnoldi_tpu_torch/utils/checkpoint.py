"""Restart-boundary snapshots of ``partial_schur`` (checkpoint/resume).

The port's copy of ``arnoldi_tpu/utils/checkpoint.py``: the same
:class:`RestartCheckpoint` fields and the same ``.npz`` keys (``V``,
``H_hp``, ``pa``, ``restart``, ``total_matvecs``, ``matvecs``,
``restarts``, ``residual_trace``, ``k_lock``), so a snapshot written by
either package resumes in the other.

Only the head rows ``V[:pa+b]`` are saved: the truncated basis and the
carry (residual) block are the whole restart-boundary state, and rows past
them are re-derived by the next expansion.  The solver takes them from the
workspace after the truncate+expand that follows the boundary (the
expansion only appends rows past ``pa+b``), as one device-to-host copy.

Under a row mesh the basis is saved per rank
(:func:`save_checkpoint_sharded`): rank k writes ``{path}.p{k}`` with its
columns under the key ``c{col0}`` (its first global column), and rank 0
writes the metadata file ``path`` (no ``V``; ``sharded``, ``head``,
``n_solve`` and the counters).  Every file carries the same generation
token, a sha1 of ``H_hp`` and the counters, so stale shard files of an
earlier save are refused.  Resume is mesh-elastic
(:func:`load_checkpoint_sharded`): a snapshot of N ranks (or of the JAX
package's N devices, one file of N pieces) loads on M ranks, each
assembling its columns from whichever pieces cover them.
Snapshots are plain ``.npz`` files written via atomic rename.
"""

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class RestartCheckpoint:
    """Solver state at a restart boundary (just before re-expansion)."""

    V: object              # (pa+b, n) head rows: truncated basis + carry
    H_hp: np.ndarray       # (m+b, m) projected matrix, float64 / complex128
    pa: int                # active compressed size (start_dim of next expand)
    restart: int           # restarts completed
    total_matvecs: int
    matvecs: np.ndarray    # per-eigenvalue history
    restarts: np.ndarray
    residual_trace: list
    k_lock: int = 0        # locked (converged, decoupled) leading pairs


def _atomic_savez(path, **arrays):
    # np.savez appends ".npz" unless the name already ends with it; write to
    # a tmp name and atomically rename onto the requested path.
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _meta_arrays(ckpt: RestartCheckpoint):
    return dict(
        H_hp=np.asarray(ckpt.H_hp),
        pa=ckpt.pa,
        restart=ckpt.restart,
        total_matvecs=ckpt.total_matvecs,
        matvecs=ckpt.matvecs,
        restarts=ckpt.restarts,
        residual_trace=np.asarray(ckpt.residual_trace, dtype=np.float64),
        k_lock=ckpt.k_lock,
    )


def save_checkpoint(path, ckpt: RestartCheckpoint):
    """Single-file snapshot; ``ckpt.V`` a NumPy array or a tensor (copied
    to the host)."""
    V = ckpt.V.cpu().numpy() if hasattr(ckpt.V, "cpu") else np.asarray(ckpt.V)
    _atomic_savez(path, V=V, **_meta_arrays(ckpt))


def load_checkpoint(path) -> RestartCheckpoint:
    """Read a snapshot; ``V`` is None for a sharded snapshot's metadata."""
    with np.load(path) as z:
        return RestartCheckpoint(
            V=z["V"] if "V" in z.files else None,
            H_hp=z["H_hp"],
            pa=int(z["pa"]),
            restart=int(z["restart"]),
            total_matvecs=int(z["total_matvecs"]),
            matvecs=z["matvecs"],
            restarts=z["restarts"],
            residual_trace=list(z["residual_trace"]),
            k_lock=int(z["k_lock"]) if "k_lock" in z else 0,
        )


def _generation(ckpt: RestartCheckpoint):
    """The save's token, the same on every rank without communication: a
    sha1 of the replicated ``H_hp`` and counters (the JAX package's)."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(ckpt.H_hp).tobytes())
    h.update(np.asarray([ckpt.restart, ckpt.total_matvecs],
                        dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def _shard_files(path):
    """``{rank: file}`` of the shard files of ``path``."""
    import glob

    out = {}
    for fn in glob.glob(f"{glob.escape(path)}.p*"):
        if fn.endswith(".tmp.npz"):
            continue
        try:
            out[int(fn[len(path) + 2:])] = fn
        except ValueError:
            continue
    return out


def save_checkpoint_sharded(path, ckpt: RestartCheckpoint, mesh):
    """Mesh snapshot: this rank's ``{path}.p{rank}`` and, on rank 0, the
    metadata file ``path``.

    ``ckpt.V`` is this rank's ``(head, n_local)`` columns of the head rows
    (a tensor or an array), whose first global column is ``rank *
    n_local``.  Rank 0 deletes shard files of ranks past the mesh (left by
    a save on more ranks), and every rank waits at a barrier until all
    files are written, so a resume that follows reads one generation."""
    V = ckpt.V.cpu().numpy() if hasattr(ckpt.V, "cpu") else np.asarray(ckpt.V)
    gen = _generation(ckpt)
    col0 = mesh.rank * V.shape[1]
    _atomic_savez(f"{path}.p{mesh.rank}", gen=np.asarray(gen),
                  **{f"c{col0}": V})
    if mesh.rank == 0:
        _atomic_savez(path, sharded=np.asarray(True), head=np.asarray(V.shape[0]),
                      n_solve=np.asarray(V.shape[1] * mesh.size),
                      gen=np.asarray(gen), **_meta_arrays(ckpt))
        for k, fn in _shard_files(path).items():
            if k >= mesh.size:
                try:
                    os.unlink(fn)
                except OSError:
                    pass
    mesh.barrier()


def load_checkpoint_sharded(path, mesh, n_solve=None) -> RestartCheckpoint:
    """A mesh snapshot with ``V`` this rank's ``(head, n_solve / size)``
    columns of the head rows, assembled from the shard pieces of the
    snapshot's generation that cover them (columns past the saved
    ``n_solve``, padding of a wider mesh, are zeros).  ``n_solve`` is this
    solve's padded size (default the saved one)."""
    ck = load_checkpoint(path)
    with np.load(path) as z:
        head, n_saved = int(z["head"]), int(z["n_solve"])
        gen = str(z["gen"]) if "gen" in z.files else None
    n_solve = n_saved if n_solve is None else int(n_solve)
    if n_solve % mesh.size:
        raise ValueError(f"n_solve={n_solve} does not divide the "
                         f"{mesh.size}-rank mesh")
    per = n_solve // mesh.size
    c0, c1 = mesh.rank * per, (mesh.rank + 1) * per

    pieces, stale = {}, []
    for _, fn in sorted(_shard_files(path).items()):
        with np.load(fn) as z:
            if gen is not None and (str(z["gen"]) if "gen" in z.files
                                    else None) != gen:
                stale.append(fn)
                continue
            for k in z.files:
                if k.startswith("c"):
                    pieces.setdefault(int(k[1:]), (fn, k))
    if not pieces:
        raise FileNotFoundError(
            f"no shard files found for {path}"
            + (f" at generation {gen} (stale-generation files ignored: "
               f"{stale})" if stale else ""))
    starts = sorted(pieces)
    dtype = None
    parts, cur = [], c0
    while cur < c1:
        if cur >= n_saved:
            parts.append(None)          # zeros, sized below
            break
        i = int(np.searchsorted(starts, cur, side="right")) - 1
        if i < 0:
            raise ValueError(f"checkpoint has no shard covering column {cur} "
                             f"(saved offsets: {starts})")
        p0 = starts[i]
        fn, key = pieces[p0]
        with np.load(fn) as z:
            arr = z[key]
        if p0 + arr.shape[1] <= cur:
            raise ValueError(f"checkpoint shard gap at column {cur} (piece at "
                             f"{p0} is {arr.shape[1]} wide)")
        hi = min(c1, p0 + arr.shape[1], n_saved)
        parts.append(arr[:, cur - p0:hi - p0])
        dtype = arr.dtype
        cur = hi
    V = np.zeros((head, per), dtype=dtype if dtype is not None else np.float64)
    at = 0
    for part in parts:
        if part is None:
            break
        V[:, at:at + part.shape[1]] = part
        at += part.shape[1]
    ck.V = V
    return ck


def checkpoint_is_sharded(path):
    """True for a mesh snapshot's metadata file."""
    with np.load(path) as z:
        return "sharded" in z.files
