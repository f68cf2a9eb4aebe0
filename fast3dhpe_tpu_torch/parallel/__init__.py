"""Data parallelism over a process group, one GPU a process, and spatial
partitioning over its "model" axis. Port of fast3dhpe_tpu/parallel
(parallel/mesh.py says what each JAX name is here; parallel/spatial.py
makes explicit what XLA partitions under a "model" axis)."""

from .distributed import (  # noqa: F401
    destroy_distributed,
    init_distributed,
    process_count,
    process_index,
    shard_records_for_host,
)
from .mesh import (  # noqa: F401
    Mesh,
    barrier,
    make_mesh,
    replicate,
    shard_batch,
    shard_batch_spatial,
    shard_stacked,
    spatial_sharding,
)
from .spatial import (  # noqa: F401
    check_split,
    gather_height,
    gather_point,
    halo_rows,
    heatmap_split,
    split_soft_argmax,
)
