"""Restart-boundary snapshots of ``partial_schur`` (checkpoint/resume).

The port's copy of the single-file half of ``arnoldi_tpu/utils/checkpoint.py``
(lines 31-84): the same :class:`RestartCheckpoint` fields and the same
``.npz`` keys (``V``, ``H_hp``, ``pa``, ``restart``, ``total_matvecs``,
``matvecs``, ``restarts``, ``residual_trace``, ``k_lock``), so a snapshot
written by either package resumes in the other.

Only the head rows ``V[:pa+b]`` are saved: the truncated basis and the
carry (residual) block are the whole restart-boundary state, and rows past
them are re-derived by the next expansion.  The solver takes them from the
workspace after the truncate+expand that follows the boundary (the
expansion only appends rows past ``pa+b``), as one device-to-host copy.

A snapshot without ``V`` is the metadata file of the JAX package's
sharded (mesh) checkpoint; the port has no mesh yet, and ``partial_schur``
refuses it.  Snapshots are plain ``.npz`` files written via atomic rename.
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
