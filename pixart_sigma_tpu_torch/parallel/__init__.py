"""Multi-rank training over torch.distributed: the mesh and its placement
rules (`mesh`), rank coordination and collectives (`dist`), and sharded
tensors seen as their local shards (`sharded`). Port of
pixart_sigma_tpu/parallel, where GSPMD over a device mesh does what FSDP2,
tensor-parallel DTensors and DDP over NCCL ranks do here."""

from pixart_sigma_tpu_torch.parallel.dist import (  # noqa: F401
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
)
from pixart_sigma_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    build_mesh,
    param_placement,
    shard_model,
)
