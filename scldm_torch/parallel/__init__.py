"""Multi-card layouts (counterpart of scldm_tpu/parallel/): the bootstrap,
the ("data", "model") mesh, data parallelism and FSDP over "data", and
gene-sequence parallelism over "model". JAX's Megatron rules
(`sharding_rules.param_pspec`) and GPipe trunk (`pipeline.py`) wait for
ROADMAP queue 1, item 11b."""

from scldm_torch.parallel.distributed import (  # noqa: F401
    maybe_initialize_distributed,
    rank,
    world_size,
)
from scldm_torch.parallel.mesh import make_mesh, shard_batch, shard_stacked_batch  # noqa: F401
