"""Process groups and data / sequence parallelism over ``torch.distributed``
(counterpart of ``mmt_tpu/parallel``; the pipeline and the Megatron-style
parameter sharding are not ported yet)."""

from mmt_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    init_distributed,
    shard_batch,
)
