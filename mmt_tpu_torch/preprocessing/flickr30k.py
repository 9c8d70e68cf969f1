"""Flickr30k retrieval inference data generator.

The port's copy of ``mmt_tpu/preprocessing/flickr30k.py``: the same records
and ``input_meta_data`` for the same inputs.

Parity: ``preprocessing/generate_flickr30k_inference_data.py`` -- splits
paired (image, 5-caption) records into image records (``image_index``)
and text records (``text_index``, ``gt_image_index``), with an optional
top-K image subsample, and writes the ``input_meta_data`` JSON the
predict CLI consumes.

Usage:
  python -m mmt_tpu_torch.preprocessing.flickr30k \
      --input_files='/data/flickr30k.{}.recordio*' --eval_data_dir=/out \
      [--topk_images=100]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from mmt_tpu_torch.data.tfrecord import TFRecordReader, TFRecordWriter, parse_example
from mmt_tpu_torch.preprocessing.records import image_example, text_example

SPLIT_SIZES = {
    "val": {"image": 1014, "text": 5070},
    "test": {"image": 1000, "text": 5000},
}


def process_split(split, input_pattern, out_dir, topk_images):
    image_key_to_index = {}
    text_key_to_index = {}
    img_path = os.path.join(out_dir, f"flickr30k.{split}.image.recordio-00000-of-00001")
    txt_path = os.path.join(out_dir, f"flickr30k.{split}.text.recordio-00000-of-00001")
    files = sorted(glob.glob(input_pattern.format(split)))
    if not files:
        raise ValueError(f"no files match {input_pattern.format(split)}")
    with TFRecordWriter(img_path) as img_writer, TFRecordWriter(txt_path) as txt_writer:
        for path in files:
            for payload in TFRecordReader(path):
                ex = parse_example(payload)
                image_key = bytes(ex["image/key"][0])
                if len(image_key_to_index) < topk_images or image_key in image_key_to_index:
                    if image_key not in image_key_to_index:
                        image_key_to_index[image_key] = len(image_key_to_index)
                        img_writer.write(
                            image_example(
                                bytes(ex["image/encoded"][0]),
                                {"image_key": image_key},
                                {"image_index": image_key_to_index[image_key]},
                            )
                        )
                for idx, caption in enumerate(ex.get("caption/tokenized_text", [])):
                    text_key = f"{image_key.decode('utf-8')}_{idx}".encode()
                    if text_key in text_key_to_index:
                        continue
                    text_key_to_index[text_key] = len(text_key_to_index)
                    txt_writer.write(
                        text_example(
                            {"caption": bytes(caption), "text_key": text_key},
                            {
                                "text_index": text_key_to_index[text_key],
                                "gt_image_index": image_key_to_index.get(image_key, -1),
                            },
                        )
                    )
    return {
        f"{split}_image_input_path": img_path,
        f"{split}_text_input_path": txt_path,
        f"{split}_num_image_examples": len(image_key_to_index),
        f"{split}_num_text_examples": len(text_key_to_index),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_files", required=True,
                   help="glob pattern with {} for the split name")
    p.add_argument("--eval_data_dir", required=True)
    p.add_argument("--topk_images", type=int, default=100)
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--splits", default="val,test")
    args = p.parse_args(argv)

    os.makedirs(args.eval_data_dir, exist_ok=True)
    meta = {"max_seq_length": args.max_seq_length}
    for split in args.splits.split(","):
        meta.update(
            process_split(split, args.input_files, args.eval_data_dir, args.topk_images)
        )
    with open(os.path.join(args.eval_data_dir, "input_meta_data"), "w") as f:
        json.dump(meta, f, indent=4)
    print(json.dumps(meta, indent=2))


if __name__ == "__main__":
    main()
