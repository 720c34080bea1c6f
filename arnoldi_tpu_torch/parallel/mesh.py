"""The row mesh: one rank a row block, over ``torch.distributed``.

Counterpart of ``arnoldi_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a device mesh and lets GSPMD insert the collectives; the
port runs SPMD instead: each rank of a process group runs the same solver
on its row block of the operator and of the transposed basis ``Vt: (m+b,
n_local)``, and everything m-sized (H, the Schur form, the sort, the
convergence tests) is replicated, computed by every rank from the same
all-reduced numbers, so every rank takes the same control flow.

:class:`Mesh` carries the process group and the collectives the solvers
use: a sum all-reduce, the all-gather of row blocks, the ring exchange of
the halo SpMV and :func:`gather_rows` (the counterpart of
``multihost_utils.process_allgather``, for tests and callers).  A one-rank
mesh needs no process group: its collectives are the identity.

Backends: NCCL takes CUDA tensors.  Gloo takes CPU tensors, and CUDA
tensors in its all-reduce and all-gather (its CUDA algorithms stage them);
its point-to-point reads a CUDA tensor's memory as host memory, so the ring
exchange stages CUDA tensors through pinned host buffers itself.  NCCL
with a CPU tensor, or any other backend, raises: nothing falls back
silently.
"""

import dataclasses

import torch

from ..utils.profiling import phase_clock

#: Name of the row-partition axis (the JAX package's ``ROWS``).
ROWS = "rows"

#: Ring tags: a block's right edge travels to the next rank (its left
#: halo), its left edge to the previous rank (its right halo).
_TAG_RIGHTWARD, _TAG_LEFTWARD = 11, 12


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D row mesh of ``size`` ranks; this process is ``rank``.

    ``group`` is the ``torch.distributed`` process group (None for a
    one-rank mesh), ``device`` the device this rank computes on (the
    operators' and the basis' device).  ``clock`` times the host side of
    the ring exchange (``mesh.ring_start``, and ``mesh.ring_wait`` for the
    handle's wait: the staging copies and the transfer) when
    ``ARNOLDI_PHASES`` is set (:func:`~..utils.profiling.phase_clock`)."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = ROWS
    clock: object = dataclasses.field(default_factory=phase_clock, compare=False,
                                      repr=False)

    @property
    def backend(self):
        """The group's backend ("nccl", "gloo"), None without a group."""
        if self.group is None:
            return None
        import torch.distributed as dist

        return str(dist.get_backend(self.group))

    def _check(self):
        if self.group is None and self.size != 1:
            raise ValueError(f"a {self.size}-rank mesh needs a process group")

    def _route(self, t, p2p=False):
        """True when ``t`` goes through a pinned host buffer: a CUDA tensor
        in gloo's point-to-point (``p2p``), which reads device memory as
        host memory ("writev: Bad address" on the card); gloo's all-reduce
        and all-gather take CUDA tensors.  Raises for a pair no route
        takes."""
        backend = self.backend
        if backend == "gloo":
            if t.device.type not in ("cpu", "cuda"):
                raise ValueError(f"gloo mesh: CPU or CUDA tensors, got {t.device}")
            return p2p and t.device.type == "cuda"
        if backend == "nccl":
            if t.device.type != "cuda":
                raise ValueError(f"NCCL mesh: CUDA tensors only, got {t.device}")
            return False
        raise ValueError(f"mesh backend {backend!r}: the port's collectives "
                         "run on 'nccl' or 'gloo'")

    def all_reduce(self, t):
        """The sum of ``t`` over the ranks, as a new tensor (``t`` itself on
        a one-rank mesh without a group)."""
        self._check()
        if self.group is None:
            return t
        import torch.distributed as dist

        self._route(t)
        out = t.clone()
        dist.all_reduce(_wire(out), group=self.group)
        return out

    def all_gather(self, t):
        """The ranks' blocks ``t`` (all of one shape) concatenated along the
        last axis, in rank order: the all-gather of ``x`` row blocks (or of
        ``(b, n_local)`` column blocks)."""
        self._check()
        if self.group is None:
            return t
        import torch.distributed as dist

        self._route(t)
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather([_wire(p) for p in parts], _wire(src), group=self.group)
        return torch.cat(parts, dim=-1)

    def ring_start(self, left_edge, right_edge):
        """Start the ring exchange of a block's edges: ``right_edge`` goes
        to the next rank, ``left_edge`` to the previous one (the ring wraps
        around).  Returns a handle whose ``wait()`` gives ``(left_halo,
        right_halo)``: the previous rank's right edge and the next rank's
        left edge, on the edges' device.  On a one-rank mesh the block is
        its own neighbour."""
        self._check()
        if self.group is None or self.size == 1:
            return _Done((right_edge, left_edge))
        with self.clock("mesh.ring_start"):
            return self._ring(left_edge, right_edge)

    def _ring(self, left_edge, right_edge):
        import torch.distributed as dist

        staged = self._route(right_edge, p2p=True)
        send_r, send_l = ((_pinned(right_edge), _pinned(left_edge)) if staged
                          else (right_edge.contiguous(), left_edge.contiguous()))
        recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        ops = [dist.P2POp(dist.isend, _wire(send_r), nxt, self.group,
                          _TAG_RIGHTWARD),
               dist.P2POp(dist.isend, _wire(send_l), prv, self.group,
                          _TAG_LEFTWARD),
               dist.P2POp(dist.irecv, _wire(recv_l), prv, self.group,
                          _TAG_RIGHTWARD),
               dist.P2POp(dist.irecv, _wire(recv_r), nxt, self.group,
                          _TAG_LEFTWARD)]
        reqs = dist.batch_isend_irecv(ops)
        return _Ring(reqs, recv_l, recv_r, right_edge.device if staged else None,
                     (send_r, send_l), self.clock)

    def barrier(self):
        self._check()
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


class _Done:
    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


class _Ring:
    def __init__(self, reqs, recv_l, recv_r, device, keep, clock):
        self._reqs, self._recv, self._device = reqs, (recv_l, recv_r), device
        self._keep = keep       # the send buffers live until the wait
        self._clock = clock

    def wait(self):
        with self._clock("mesh.ring_wait"):
            for req in self._reqs:
                req.wait()
            self._keep = None
            if self._device is None:
                return self._recv
            return tuple(t.to(self._device) for t in self._recv)


def _wire(t):
    """``t`` as the collectives carry it: a complex tensor as its real view
    (the same memory)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _pinned(t):
    """A pinned host copy of ``t`` (a CUDA tensor)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def make_mesh(n_devices=None, group=None, *, device=None, axis_name=ROWS):
    """The row mesh over ``group`` (default: the initialized default
    group), this process its rank.

    Without an initialized process group the mesh has one rank and needs
    none.  ``n_devices``, when given, must equal the group's size (a rank
    drives one device).  ``device`` is where this rank computes; default
    the card (``cuda``, the current device), ``cpu`` to run the plain
    versions."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, size = 0, 1
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"requested {n_devices} devices, the process group has {size} "
            "ranks (one device a rank; initialize the group with "
            "arnoldi_tpu_torch.parallel.multihost.initialize)")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cuda"))
    return Mesh(group, rank, size, torch.device(device), axis_name)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """The rows layout (the JAX package's ``row_sharding``): ``place(t)``
    keeps this rank's block of ``t``'s first axis, on the mesh's device."""

    mesh: Mesh
    ndim: int = 1

    def place(self, t):
        row0, row1 = local_rows(t.shape[0], self.mesh)
        return t[row0:row1].contiguous().to(self.mesh.device)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """The replicated layout (``replicated_sharding``): ``place(t)`` keeps
    the whole of ``t`` on the mesh's device."""

    mesh: Mesh

    def place(self, t):
        return t.to(self.mesh.device)


def row_sharding(mesh, ndim=1):
    """The layout partitioning the first axis over the mesh's ranks."""
    return RowSharding(mesh, ndim)


def replicated_sharding(mesh):
    """The layout every rank holds whole."""
    return Replicated(mesh)


def local_rows(n_solve, mesh):
    """``(row0, row1)``: this rank's rows of an ``n_solve``-row operator,
    which the mesh size divides."""
    if n_solve % mesh.size:
        raise ValueError(f"{n_solve} rows do not divide the {mesh.size}-rank "
                         "mesh; pad the operator first (pad_operator)")
    per = n_solve // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def gather_rows(t, mesh):
    """Every rank's block of rows of ``t`` (the first axis; blocks may
    differ in length, as the last rank's unpadded rows do), concatenated in
    rank order on every rank."""
    mesh._check()
    if mesh.group is None:
        return t
    lens = mesh.all_gather(torch.tensor([t.shape[0]], dtype=torch.int64,
                                        device=t.device))
    lens = [int(v) for v in lens.cpu()]
    top = max(lens)
    pad = t.new_zeros((top, *t.shape[1:]))
    pad[:t.shape[0]] = t
    flat = mesh.all_gather(pad.reshape(1, -1)).reshape(mesh.size, top,
                                                       *t.shape[1:])
    return torch.cat([flat[r, :lens[r]] for r in range(mesh.size)])
