"""Multi-process execution helpers.

Counterpart of ``arnoldi_tpu/parallel/multihost.py``.  Every process
calls :func:`initialize` (idempotent) with the coordinator's address, the
process count and its own rank (nothing on the machine announces a
cluster), builds the mesh with :func:`make_slice_mesh`, and loads its rows
with :func:`process_local_rows`; everything else in the port takes the
mesh as it is.
"""

import os

import torch

from .mesh import ROWS, make_mesh

_initialized = False


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, backend=None):
    """Initialize the default ``torch.distributed`` process group
    (idempotent; a no-op for a single process without a coordinator).

    ``coordinator_address`` is ``host:port`` or a full ``init_method``
    (default: ``$ARNOLDI_COORDINATOR_ADDRESS``); ``num_processes`` and
    ``process_id`` default to ``$WORLD_SIZE`` and ``$RANK``.  The backend is
    NCCL where a card is present and gloo on the CPU, unless ``backend``
    names one."""
    global _initialized
    import torch.distributed as dist

    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("ARNOLDI_COORDINATOR_ADDRESS")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if coordinator_address is None and num_processes is None:
        return     # a single process: nothing to initialize
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    method = (coordinator_address if "://" in str(coordinator_address)
              else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=method,
                            world_size=int(num_processes), rank=int(process_id))
    _initialized = True


def make_slice_mesh(axis_name=ROWS, *, device=None):
    """The row mesh over every process of the default group, in rank
    order (one rank a device); one rank without a group."""
    return make_mesh(device=device, axis_name=axis_name)


def process_local_rows(n, mesh, row_granularity=1):
    """The [start, stop) global rows this rank owns under the solvers' row
    partition (for loading each rank's data).

    The solvers' padding rule: the row count is padded to a multiple of
    ``size * row_granularity`` (the block height for BSR, 1 otherwise), so
    shard boundaries fall on multiples of the padded per-rank size,
    clamped back to ``n``."""
    gran = mesh.size * int(row_granularity)
    n_solve = -(-n // gran) * gran
    per = n_solve // mesh.size
    return min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
