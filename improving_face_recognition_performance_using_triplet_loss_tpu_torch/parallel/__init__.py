"""Data and class parallelism over ``torch.distributed``: process groups
(``distributed``), ``DeviceMesh`` layouts and each rank's block
(``mesh``), and collectives with stated backward rules
(``collectives``).

The JAX package runs one controller over a device mesh and lets
``shard_map`` transpose its collectives. The port runs one process per
rank: each feeds its own block of a global batch, and every collective a
gradient passes through names its backward by hand. Run plainly, an entry
point is world 1 (a process group of one); under ``python -m
torch.distributed.run`` it spans the ranks."""

from .distributed import (  # noqa: F401
    initialize_distributed,
    process_group,
    process_info,
    rank_device,
)
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    bind_mesh,
    bound_axis,
    data_sharding,
    local_block,
    make_2d_mesh,
    make_mesh,
    make_multislice_mesh,
    replicated_sharding,
)
