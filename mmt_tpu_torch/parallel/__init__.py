"""Process groups, and data, sequence, pipeline and tensor parallelism over
``torch.distributed`` (counterpart of ``mmt_tpu/parallel``)."""

from mmt_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    create_pipe_mesh,
    init_distributed,
    shard_batch,
)
from mmt_tpu_torch.parallel.param_sharding import (  # noqa: F401
    param_spec,
    shard_params,
    shard_params_in_process,
)
from mmt_tpu_torch.parallel.pipeline import (  # noqa: F401
    EncoderPipeline,
    InProcessTransport,
    P2PTransport,
    pipelined_encoder_sequence_output,
)
