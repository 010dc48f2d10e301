"""Batch and row sharding over CUDA devices, and multi-process start on
``torch.distributed`` (counterpart of ``rls_tpu/parallel``). The names of
``__all__`` are those of ``rls_tpu.parallel``; ``Mesh``,
``BatchSharding``, ``RowShardedOperator`` and ``replicate`` are the
port's own pieces under them."""

from .mesh import (
    BatchSharding,
    Mesh,
    RowShardedOperator,
    batch_sharding,
    make_mesh,
    replicate,
    row_sharded_operator,
    shard_batch,
    solve_admm_tv_fused_sharded,
    solve_batched_sharded,
    solve_cgnr_fused_sharded,
    solve_fista_tv_fused_sharded,
    solve_fused_sharded,
    solve_pdhg_fused_sharded,
    solve_pgm_dense_fused_sharded,
)
from .multihost import global_mesh, initialize_multihost, is_multihost

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "row_sharded_operator",
    "solve_batched_sharded",
    "solve_fista_tv_fused_sharded",
    "solve_admm_tv_fused_sharded",
    "solve_cgnr_fused_sharded",
    "solve_pdhg_fused_sharded",
    "solve_pgm_dense_fused_sharded",
    "solve_fused_sharded",
    "initialize_multihost",
    "is_multihost",
    "global_mesh",
]
