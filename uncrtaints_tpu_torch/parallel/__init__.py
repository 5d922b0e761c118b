"""Data parallel over processes, one per GPU (port of uncrtaints_tpu/parallel)."""

from uncrtaints_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, active, all_reduce_sum, barrier, broadcast_module, current_mesh, make_mesh,
    maybe_init_distributed, row_split, shard_batch)
