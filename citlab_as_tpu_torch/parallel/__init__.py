from citlab_as_tpu_torch.parallel.mesh import (
    make_mesh, shard_batch, replicate, data_parallel_jit, spatial_sharding, place_rows,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "data_parallel_jit",
           "spatial_sharding", "place_rows"]
