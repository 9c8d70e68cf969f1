"""Offline preprocessing CLIs: dataset -> TFRecords + input_meta_data JSON.

Counterpart of ``mmt_tpu/preprocessing/`` (the reference's
``preprocessing/`` scripts: Fashion-Gen split / metadata / retrieval
scripts, Flickr30k and WIT inference-data generators) over the port's
TFRecord codec, without pandas: the same files for the same inputs.
"""

from mmt_tpu_torch.preprocessing.records import (  # noqa: F401
    get_txt_info,
    image_example,
    text_example,
)
