"""Data parallel over processes, one per GPU, and the 2-D data x spatial mesh
(port of uncrtaints_tpu/parallel)."""

from uncrtaints_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, Mesh2D, active, all_reduce_sum, all_reduce_sum_grad, barrier, broadcast_module,
    current_mesh, current_mesh_2d, halo_exchange, make_mesh, make_mesh_2d,
    maybe_init_distributed, row_split, shard_batch, spatial, spatial_sharding, spatial_sum,
    use_mesh_2d)
