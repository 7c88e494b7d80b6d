"""Multi-card layouts (counterpart of scldm_tpu/parallel/): the bootstrap,
the ("data", "model") mesh, data parallelism and FSDP over "data", and over
"model" gene-sequence parallelism (`gene_sp.py`), the GPipe DiT trunk
(`pipeline.py`) and Megatron tensor parallelism (`sharding_rules.py` with
`tensor_parallel.py`)."""

from scldm_torch.parallel.distributed import (  # noqa: F401
    maybe_initialize_distributed,
    rank,
    world_size,
)
from scldm_torch.parallel.mesh import make_mesh, shard_batch, shard_stacked_batch  # noqa: F401
