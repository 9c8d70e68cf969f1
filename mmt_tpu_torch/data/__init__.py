"""Input pipelines of the port: TFRecord IO, example assembly, the
pretraining, classification and retrieval loaders, the multiprocess
prefetch, and the dummy pretraining stream."""

from mmt_tpu_torch.data.tfrecord import (  # noqa: F401
    TFRecordReader,
    TFRecordWriter,
    build_example,
    parse_example,
)
