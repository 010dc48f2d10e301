"""Device meshes: batch sharding of multi-RHS solves over CUDA devices and
row sharding of a dense operator.

PyTorch counterpart of ``rls_tpu/parallel/mesh.py``: ``make_mesh``
(:41-51), ``batch_sharding`` and ``shard_batch`` (:54-61),
``row_sharded_operator`` (:64-68), ``solve_batched_sharded`` (:71-82),
``solve_fused_sharded`` with its replica cache (:85-119) and its five
wrappers (:122-167).

Torch has no global sharded array and no GSPMD, so the port does by hand
what ``shard_map`` and ``NamedSharding`` do there:

  * **batch axis**: the columns of B are cut into equal contiguous chunks,
    one per device along the axis, in mesh order. Each chunk is solved by
    a replica of the solver on its device (:func:`replicate`), and the
    results are copied to the mesh's first device and concatenated in
    column order: the one copy per shard at the end. On one process no
    collective runs at all.
  * **row axis**: :func:`row_sharded_operator` keeps the row blocks of a
    dense matrix on the devices of the axis. ``rmv`` and ``normal`` move
    the blocks' partials to the home device and sum them in block order,
    so the result does not depend on timing (GSPMD's psum, in a fixed
    order).

Shards on distinct devices are issued before any result is read: the
fused kernels from one host thread (their launches return at once), a
composed solve (whose loop reads its convergence mask on the host every
step) on one host thread per device. **Shards that share a device run in
turn on that device's current stream.** The grid kernels of rows 6, 7a
and 7b meet at barriers across a grid sized to the card's resident CTAs,
and the cluster kernels size their waves by the clusters the card holds
at once, so two such launches at once on one card are not assumed safe.
A mesh may name one device several times (``[torch.device("cpu")] * 4``
stands in for JAX's virtual CPU devices in the tests; ``[cuda:0,
cuda:0]`` runs two shards on one card).

Draws: a solver's random draws come from a ``torch.Generator`` that its
``init`` seeds with the solver's seed on b's device, and a generator held
by the solver itself is replicated from its initial seed, so every
replica starts from the solver's seed. A randomized Kaczmarz draws its
rows once per sweep for the whole batch (with ``precompute_order=True``
once, at construction), so the sharded solve draws what the unsharded
batch draws.

Not ported: the HLO audits of ``tests/test_sharding.py:116-149`` (no
all-gather, a psum present). They read XLA's compiled program, which
torch has no counterpart for, and the port's sharded solve has no
collective at all on one process. Nor the ``interpret=`` flags (ROADMAP
"What not to port").
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.base import LinearOperator

__all__ = [
    "Mesh",
    "BatchSharding",
    "RowShardedOperator",
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "row_sharded_operator",
    "replicate",
    "solve_batched_sharded",
    "solve_fused_sharded",
    "solve_fista_tv_fused_sharded",
    "solve_admm_tv_fused_sharded",
    "solve_cgnr_fused_sharded",
    "solve_pgm_dense_fused_sharded",
    "solve_pdhg_fused_sharded",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes: `devices` an array of
    ``torch.device`` shaped like the mesh. `ranks`, on a mesh that spans
    processes (:func:`~rls_tpu_torch.parallel.global_mesh`), holds the
    process that owns each entry; None on one process."""

    devices: np.ndarray
    axis_names: tuple
    ranks: Optional[np.ndarray] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r}; its axes are {self.axis_names}")
        return self.axis_names.index(axis)

    def along(self, axis: str) -> list:
        """The positions of `axis` at index 0 of every other axis, as
        (device, rank) pairs in mesh order (rank None on one process)."""
        k = self.axis_index(axis)
        index = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        devices = list(self.devices[index])
        ranks = [None] * len(devices) if self.ranks is None else list(self.ranks[index])
        return list(zip(devices, ranks))

    def position(self, axis: str, i: int) -> "Mesh":
        """The mesh of position `i` along `axis`: that axis taken out."""
        k = self.axis_index(axis)
        names = self.axis_names[:k] + self.axis_names[k + 1:]
        ranks = None if self.ranks is None else np.take(self.ranks, i, axis=k)
        return Mesh(np.take(self.devices, i, axis=k), names, ranks)

    @property
    def home(self) -> torch.device:
        """The first device of the mesh that this process owns."""
        for d, r in zip(self.devices.flat, (None,) * self.size if self.ranks is None
                        else self.ranks.flat):
            if r is None or r == _rank():
                return d
        raise ValueError("the mesh holds no device of this process")


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _device_array(devices, shape):
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("batch",),
    devices=None,
) -> Mesh:
    """A device mesh; by default every CUDA device on one "batch" axis.
    Without a CUDA device, `devices` must be given: the mesh is never
    built on the CPU unasked. A device may appear more than once."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a mesh "
                               "elsewhere, e.g. [torch.device('cpu')] * 4")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"make_mesh: shape {tuple(shape)} has {len(shape)} axes, "
                         f"axis_names {axis_names} {len(axis_names)}")
    return Mesh(_device_array(devices, tuple(shape)), axis_names)


@dataclasses.dataclass(frozen=True, eq=False)
class BatchSharding:
    """The columns of an (m, K) batch over `axis` of `mesh`: equal
    contiguous chunks, one per position of the axis, in mesh order (the
    counterpart of ``NamedSharding(mesh, P(None, axis))``)."""

    mesh: Mesh
    axis: str = "batch"

    def chunks(self, K: int) -> list:
        """The column slices of the positions; K not divisible by the
        axis size raises ValueError, as JAX's ``device_put`` does."""
        count = len(self.mesh.along(self.axis))
        if K % count:
            raise ValueError(f"{K} columns do not split evenly over the {count} positions of "
                             f"axis {self.axis!r}")
        width = K // count
        return [slice(i * width, (i + 1) * width) for i in range(count)]

    def local(self, K: int) -> list:
        """(position, device, column slice) of each position this process
        owns (every position on one process)."""
        me = _rank()
        return [(i, d, s) for i, ((d, r), s) in
                enumerate(zip(self.mesh.along(self.axis), self.chunks(K)))
                if r is None or r == me]


def batch_sharding(mesh: Mesh, axis: str = "batch") -> BatchSharding:
    """The placement of a (m, K) multi-RHS matrix: columns over `axis`."""
    mesh.axis_index(axis)
    return BatchSharding(mesh, axis)


def shard_batch(B, mesh: Mesh, axis: str = "batch") -> list:
    """The column chunks of the (m, K) batch `B`, each on its device along
    `axis`, in mesh order (on a mesh that spans processes, this process's
    chunks)."""
    return [B[:, s].to(d) for _, d, s in batch_sharding(mesh, axis).local(B.shape[1])]


class RowShardedOperator(LinearOperator):
    """A dense matrix whose row blocks lie on several devices. Vectors
    live on the home device (the first block's): ``mv`` concatenates the
    blocks' products there, ``rmv`` and ``normal`` sum the blocks'
    partials there in block order. It is no ``DenseOperator``, so no dense
    kernel's check accepts it and ``solve_batched_fast`` takes the
    composed path. ``.to()`` does not move the blocks;
    :func:`replicate` places them."""

    def __init__(self, blocks, axis: str = "rows"):
        super().__init__()
        self.blocks = tuple(blocks)
        self.axis = axis
        self._device = self.blocks[0].device

    @property
    def devices(self) -> list:
        return [b.device for b in self.blocks]

    @property
    def in_size(self) -> int:
        return self.blocks[0].shape[1]

    @property
    def out_size(self) -> int:
        return sum(b.shape[0] for b in self.blocks)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def check_device(self, t: torch.Tensor) -> None:
        if t.device != self._device:
            raise ValueError(f"RowShardedOperator's vectors live on {self._device} but got a "
                             f"tensor on {t.device}; move it explicitly")

    def _split(self, y):
        self.check_device(y)
        return torch.split(y, [b.shape[0] for b in self.blocks], dim=-1)

    def _sum(self, parts):
        out = None
        for p in parts:  # in block order, on the home device
            p = p.to(self._device)
            out = p if out is None else out + p
        return out

    def mv(self, x):
        self.check_device(x)
        parts = [x.to(b.device) @ b.T for b in self.blocks]
        return torch.cat([p.to(self._device) for p in parts], dim=-1)

    def rmv(self, y):
        parts = [yi.to(b.device) @ b.conj() for yi, b in zip(self._split(y), self.blocks)]
        return self._sum(parts)

    def normal(self, x):
        self.check_device(x)
        parts = []
        for b in self.blocks:
            xb = x.to(b.device)
            parts.append((xb @ b.T) @ b.conj())
        return self._sum(parts)

    def placed(self, where) -> "RowShardedOperator":
        """The same blocks on the devices of `where`: a Mesh whose `axis`
        has one position per block puts block i on its i-th device; any
        other Mesh, or a device, puts every block on its (home) device."""
        if isinstance(where, Mesh):
            if self.axis in where.axis_names and len(where.along(self.axis)) == len(self.blocks):
                devices = [d for d, _ in where.along(self.axis)]
            else:
                devices = [where.home] * len(self.blocks)
        else:
            devices = [torch.device(where)] * len(self.blocks)
        if devices == self.devices:
            return self
        return RowShardedOperator([b.to(d) for b, d in zip(self.blocks, devices)], self.axis)


def row_sharded_operator(mat, mesh: Mesh, axis: str = "rows") -> RowShardedOperator:
    """`mat` (m, n) cut into equal row blocks, block i on the i-th device
    along `axis` (at index 0 of the other axes)."""
    along = mesh.along(axis)
    if any(r is not None and r != _rank() for _, r in along):
        raise ValueError("row_sharded_operator: the row axis spans processes")
    mat = torch.as_tensor(mat)
    if mat.shape[0] % len(along):
        raise ValueError(f"{mat.shape[0]} rows do not split evenly over the {len(along)} "
                         f"positions of axis {axis!r}")
    blocks = torch.chunk(mat, len(along), dim=0)
    return RowShardedOperator([b.to(d) for b, (d, _) in zip(blocks, along)], axis)


# torch.nn.Module's own dictionaries, walked separately from its attributes
_MODULE_DICTS = ("_modules", "_buffers", "_parameters")


class _Replicator:
    """One walk of :func:`replicate`: moves every tensor, module,
    generator and row-sharded operator it meets to `home` (the blocks of a
    row-sharded operator over `where` when that is a Mesh), copying the
    dataclasses and modules that hold them; an object met twice is
    replicated once."""

    def __init__(self, where):
        self.where = where
        self.home = where.home if isinstance(where, Mesh) else torch.device(where)
        self.memo = {}

    def __call__(self, obj):
        key = id(obj)
        if key not in self.memo:
            self.memo[key] = (obj, self._replica(obj))  # keep obj alive: ids stay unique
        return self.memo[key][1]

    def _replica(self, obj):
        if torch.is_tensor(obj):
            return obj.to(self.home)
        if isinstance(obj, torch.Generator):
            gen = torch.Generator(device=self.home)
            gen.manual_seed(obj.initial_seed())
            return gen
        if isinstance(obj, RowShardedOperator):
            return obj.placed(self.where)
        if isinstance(obj, nn.Module):
            return self._module(obj)
        if isinstance(obj, (tuple, list)):
            return type(obj)(self(o) for o in obj)
        if self._walked(obj):
            new = copy.copy(obj)
            for k, v in vars(obj).items():
                object.__setattr__(new, k, self(v))
            return new
        return obj

    @staticmethod
    def _walked(obj) -> bool:
        """A dataclass instance or an instance of a class of this package:
        its attributes are walked."""
        if isinstance(obj, type) or not hasattr(obj, "__dict__"):
            return False
        return dataclasses.is_dataclass(obj) or type(obj).__module__.startswith("rls_tpu_torch.")

    def _module(self, mod: nn.Module) -> nn.Module:
        """`mod` itself where every part of it already lies on `home` and
        no row-sharded operator is inside; else a copy whose buffers,
        parameters, tensor attributes and submodules are replicated."""
        inside = list(mod.modules())
        if not any(isinstance(m, RowShardedOperator) for m in inside) and all(
            t.device == self.home for m in inside
            for t in (*m.buffers(recurse=False), *m.parameters(recurse=False),
                      *(v for v in vars(m).values() if torch.is_tensor(v)))
        ) and all(vars(m).get("_device", self.home) == self.home for m in inside):
            return mod
        new = copy.copy(mod)
        new._modules = {k: None if v is None else self(v) for k, v in mod._modules.items()}
        new._buffers = {k: None if v is None else v.to(self.home) for k, v in mod._buffers.items()}
        new._parameters = {
            k: None if v is None else nn.Parameter(v.detach().to(self.home), v.requires_grad)
            for k, v in mod._parameters.items()
        }
        for k, v in vars(mod).items():
            if k not in _MODULE_DICTS and torch.is_tensor(v):
                object.__setattr__(new, k, v.to(self.home))
        if "_device" in vars(mod):
            new._device = self.home
        return new


def replicate(solver, device):
    """A copy of `solver` on `device`: its operator modules, tensors,
    generators (from their initial seeds) and regularizer terms moved
    there; parts already there are shared, not copied, and a part held
    twice (A and AHA's A) stays one part. `device` may be a Mesh (a
    shard's position of a 2-D mesh): then everything goes to its first
    device and a row-sharded operator's blocks over its devices. Tensors
    that a plain function closes over (a plug-and-play model given as a
    lambda) are not reached."""
    return _Replicator(device)(solver)


def _run_by_device(jobs):
    """Run ``(device, fn)`` jobs; the jobs of one device in turn, each
    device on a host thread of its own where there are several. Returns
    the results in job order; a job's exception is raised."""
    groups: dict = {}
    for i, (device, _) in enumerate(jobs):
        groups.setdefault(device, []).append(i)
    out = [None] * len(jobs)

    def run(device, indices):
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with ctx:
            for i in indices:
                out[i] = jobs[i][1]()

    if len(groups) == 1:
        run(*next(iter(groups.items())))
        return out
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        futures = [pool.submit(run, d, idx) for d, idx in groups.items()]
        for f in futures:
            f.result()
    return out


def _gather(outs, mesh: Mesh):
    """The shards' (n, k) results as one (n, K) tensor on the mesh's home
    device, in column order; across processes, every process's columns,
    gathered in rank order."""
    local = torch.cat([o.to(mesh.home) for o in outs], dim=1)
    if mesh.ranks is None:
        return local
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts, dim=1)


def solve_batched_sharded(solver, B, mesh: Mesh, axis: str = "batch", x0=None):
    """``solve_batched`` with the columns of B sharded over `axis`: each
    shard is solved by a replica of `solver` on its device (on a 2-D mesh,
    over its position's devices: a row-sharded operator's blocks go to the
    devices of its row axis there), and the results come back as one
    (n, K) tensor on the mesh's first device. `x0` is one start for every
    problem (n,) or one per problem (K, n)."""
    from ..models.solvers.base import solve_batched

    jobs = []
    for i, device, cols in batch_sharding(mesh, axis).local(B.shape[1]):
        where = mesh.position(axis, i)
        replica = replicate(solver, where if where.axis_names else device)
        b = B[:, cols].to(device)
        x = None if x0 is None else (x0[cols] if x0.ndim == 2 else x0).to(device)
        jobs.append((device, lambda r=replica, b=b, x=x: solve_batched(r, b, x)))
    return _gather(_run_by_device(jobs), mesh)


# replicas of the fused paths, keyed on (solve_fn, id(solver), device); an
# entry pins its solver so the id cannot be recycled while it lives
_FUSED_SHARDED_CACHE: dict = {}


def _fused_replica(solve_fn, solver, device):
    key = (solve_fn, id(solver), device)
    entry = _FUSED_SHARDED_CACHE.get(key)
    if entry is None or entry[0] is not solver:
        if len(_FUSED_SHARDED_CACHE) > 64:
            _FUSED_SHARDED_CACHE.clear()
        entry = (solver, replicate(solver, device))
        _FUSED_SHARDED_CACHE[key] = entry
    return entry[1]


def solve_fused_sharded(solve_fn, solver, B, mesh: Mesh, axis: str = "batch"):
    """Run a fused whole-solve wrapper (``solve_pgm_tv_fused``,
    ``solve_admm_tv_fused``, …) on the columns of B sharded over `axis`:
    one launch of its kernel per shard, on a cached replica of `solver`
    on the shard's device. Problems are independent, so no collective
    runs. The launches are all issued before any result is read; shards
    that share a device run in turn on its stream."""
    outs = [solve_fn(_fused_replica(solve_fn, solver, device), B[:, cols].to(device))
            for _, device, cols in batch_sharding(mesh, axis).local(B.shape[1])]
    return _gather(outs, mesh)


def solve_fista_tv_fused_sharded(solver, B, mesh: Mesh, axis: str = "batch"):
    """Sharded fused FISTA / OptISTA / POGM-TV solve (see
    :func:`solve_fused_sharded`)."""
    from ..kernels.fista_tv_fused import solve_pgm_tv_fused

    return solve_fused_sharded(solve_pgm_tv_fused, solver, B, mesh, axis)


def solve_admm_tv_fused_sharded(solver, B, mesh: Mesh, axis: str = "batch"):
    """Sharded fused ADMM-TV solve (see :func:`solve_fused_sharded`)."""
    from ..kernels.admm_tv_fused import solve_admm_tv_fused

    return solve_fused_sharded(solve_admm_tv_fused, solver, B, mesh, axis)


def solve_cgnr_fused_sharded(solver, B, mesh: Mesh, axis: str = "batch"):
    """Sharded fused whole-solve CGNR (see :func:`solve_fused_sharded`)."""
    from ..kernels.cgnr_fused import solve_cgnr_fused

    return solve_fused_sharded(solve_cgnr_fused, solver, B, mesh, axis)


def solve_pgm_dense_fused_sharded(solver, B, mesh: Mesh, axis: str = "batch"):
    """Sharded fused dense PGM solve (see :func:`solve_fused_sharded`)."""
    from ..kernels.pgm_dense_fused import solve_pgm_dense_fused

    return solve_fused_sharded(solve_pgm_dense_fused, solver, B, mesh, axis)


def solve_pdhg_fused_sharded(solver, B, mesh: Mesh, axis: str = "batch"):
    """Sharded fused whole-solve PDHG (see :func:`solve_fused_sharded`)."""
    from ..kernels.pdhg_fused import solve_pdhg_fused

    return solve_fused_sharded(solve_pdhg_fused, solver, B, mesh, axis)
