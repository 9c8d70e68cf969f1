"""Shared example helpers (parity: ``preprocessing/utils.py``).

The port's copy of ``mmt_tpu/preprocessing/records.py``, over the port's
TFRecord codec: the same bytes for the same inputs.
"""

from __future__ import annotations

import io
from typing import Dict, Optional

from mmt_tpu_torch.data.tfrecord import build_example


def _image_shape(image_bytes: bytes):
    from PIL import Image

    im = Image.open(io.BytesIO(image_bytes))
    width, height = im.size
    depth = len(im.getbands())
    return height, width, depth


def image_example(
    image_bytes: bytes,
    string_dict: Dict[str, bytes],
    int_dict: Optional[Dict[str, int]] = None,
) -> bytes:
    """Serialized Example with image_data + height/width/depth + extras.

    Parity: ``preprocessing/utils.py:38-53``.
    """
    height, width, depth = _image_shape(image_bytes)
    features = {
        "height": [height],
        "width": [width],
        "depth": [depth],
        "image_data": [image_bytes],
    }
    for k, v in string_dict.items():
        features[k] = [v if isinstance(v, bytes) else str(v).encode()]
    for k, v in (int_dict or {}).items():
        features[k] = [int(v)]
    return build_example(features)


def text_example(
    string_dict: Dict[str, bytes], int_dict: Optional[Dict[str, int]] = None
) -> bytes:
    """Parity: ``preprocessing/utils.py:56-64``."""
    features = {}
    for k, v in string_dict.items():
        features[k] = [v if isinstance(v, bytes) else str(v).encode()]
    for k, v in (int_dict or {}).items():
        features[k] = [int(v)]
    return build_example(features)


def get_txt_info(path: str, description_key: str = "description") -> Dict:
    """Fashion-Gen info file parser (parity: ``preprocessing/utils.py:67-96``):
    one \\x01-separated line per image with
    (image_main_id, image_id, category, _, sub_category, _, description)."""
    txt_info = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split("\x01")
            txt_info[parts[1]] = {
                "image_main_id": parts[0].encode(),
                "image_id": parts[1].encode(),
                "category": parts[2].encode(),
                "sub_category": parts[4].encode(),
                description_key: parts[6].encode(),
            }
    return txt_info
