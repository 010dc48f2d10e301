"""Multi-process start on ``torch.distributed``.

PyTorch counterpart of ``rls_tpu/parallel/multihost.py`` (:27-72). The
scaling story is the same as there:

  1. :func:`initialize_multihost` in every process: it starts the process
     group (``torch.distributed.init_process_group``), from explicit
     arguments or from the ``env://`` variables that ``torchrun`` sets;
  2. :func:`global_mesh`: a mesh whose batch axis runs over every
     process's local devices;
  3. ``solve_batched_sharded`` (and the fused wrappers) on that mesh: each
     process solves its own columns, and the result is gathered
     (``all_gather``) in rank order, so every process ends with the whole
     (n, K) result.

One process with one or several cards needs no initialization; these
helpers are no-ops there. The backend is the caller's choice (``"nccl"``
between cards, ``"gloo"`` on CPUs); it is never chosen by what hardware
is found.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["initialize_multihost", "is_multihost", "global_mesh"]

# what torchrun sets for init_method="env://"
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """Start the process group (a no-op where it runs already, or for one
    process). With every argument None it reads the ``env://`` variables
    that ``torchrun`` sets; their absence is the single-process no-op.
    `coordinator_address` is ``"host:port"`` (or a full init-method URL).
    Explicit arguments that fail to start the group raise: swallowing the
    error would quietly turn a multi-process job into one process."""
    import torch.distributed as dist

    if dist.is_initialized() or num_processes == 1:
        return
    if coordinator_address is None and num_processes is None and process_id is None:
        if not all(k in os.environ for k in _ENV) or int(os.environ["WORLD_SIZE"]) == 1:
            return
        dist.init_process_group(backend, init_method="env://")
        return
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend,
        init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
    )


def is_multihost() -> bool:
    """True where the process group runs with more than one process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(axis_names=("batch",), shape=None, devices=None):
    """A mesh over the devices of every process, rank by rank: `devices`
    are this process's (default: every CUDA device it sees). Each process
    learns the others' devices from the process group. On one process it
    is :func:`make_mesh` of `devices`."""
    from .mesh import Mesh, _device_array, make_mesh

    if not is_multihost():
        return make_mesh(shape=shape, axis_names=axis_names, devices=devices)
    import torch.distributed as dist

    local = make_mesh(axis_names=("batch",), devices=devices).devices.tolist()
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local])
    me = dist.get_rank()
    entries, ranks = [], []
    for r, theirs in enumerate(names):
        entries += local if r == me else [torch.device(d) for d in theirs]
        ranks += [r] * len(theirs)
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(entries),) + (1,) * (len(axis_names) - 1)
    return Mesh(_device_array(entries, tuple(shape)), axis_names,
                _device_array(ranks, tuple(shape)))
