"""Several devices (counterpart of ``crdr_tpu/parallel/``): meshes and batch
shards (``mesh.py``), ranks and their collectives (``distributed.py``), one
image's height over a mesh (``spatial.py``)."""

from .distributed import (all_reduce_mean_, batch_mean, broadcast_,
                          init_distributed, mean_over_ranks, spawn)
from .mesh import gather, make_mesh, shard_batch, shard_rows
from .spatial import (SpatialSplitError, TileExchange, grid_margin,
                      row_halo, tile_plan)
