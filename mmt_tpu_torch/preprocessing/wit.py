"""WIT retrieval inference data generator.

The port's copy of ``mmt_tpu/preprocessing/wit.py``: the same records
and ``input_meta_data`` for the same inputs.

Parity: ``preprocessing/generate_wit_inference_data.py`` -- dedups
images by ``canonical_doc_id``, collects all text variants per id,
assigns image/text indices + gt_image_index, writes image/text records
and the ``input_meta_data`` JSON.

Usage:
  python -m mmt_tpu_torch.preprocessing.wit \
      --input_files='/data/wit.{}.recordio*' --eval_data_dir=/out
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os

from mmt_tpu_torch.data.tfrecord import TFRecordReader, TFRecordWriter, build_example, parse_example

TEXT_KEYS = {
    "canonical_doc_id",
    "caption_attribution_description",
    "caption_reference_description",
    "caption_alt_text_description",
    "page_title",
    "context_page_description",
}
IMAGE_KEYS = {"image_data", "canonical_doc_id"}


def process_split(split, input_pattern, out_dir):
    id_to_image = collections.OrderedDict()
    id_to_texts = collections.defaultdict(list)
    files = sorted(glob.glob(input_pattern.format(split)))
    if not files:
        raise ValueError(f"no files match {input_pattern.format(split)}")
    for path in files:
        basename = os.path.basename(path)
        for payload in TFRecordReader(path):
            ex = parse_example(payload)
            doc_id = bytes(ex["canonical_doc_id"][0]).decode("utf-8")
            image_features = {k: v for k, v in ex.items() if k in IMAGE_KEYS}
            text_features = {k: v for k, v in ex.items() if k in TEXT_KEYS}
            image_features["source"] = [basename.encode()]
            text_features["source"] = [basename.encode()]
            if doc_id not in id_to_image:
                id_to_image[doc_id] = image_features
            if text_features in id_to_texts[doc_id]:
                continue  # duplicate text variant
            id_to_texts[doc_id].append(text_features)

    img_path = os.path.join(out_dir, f"wit.{split}.recordio.image-00001-of-00001")
    txt_path = os.path.join(out_dir, f"wit.{split}.recordio.text-00001-of-00001")
    img_id_to_idx = {}
    with TFRecordWriter(img_path) as w:
        for idx, (doc_id, feat) in enumerate(id_to_image.items()):
            feat["image_index"] = [idx]
            img_id_to_idx[doc_id] = idx
            w.write(build_example(feat))
    n_txt = 0
    with TFRecordWriter(txt_path) as w:
        for doc_id, texts in id_to_texts.items():
            for feat in texts:
                feat["text_index"] = [n_txt]
                feat["gt_image_index"] = [img_id_to_idx[doc_id]]
                w.write(build_example(feat))
                n_txt += 1
    return {
        f"{split}_image_input_path": img_path,
        f"{split}_text_input_path": txt_path,
        f"{split}_num_image_examples": len(img_id_to_idx),
        f"{split}_num_text_examples": n_txt,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_files", required=True)
    p.add_argument("--eval_data_dir", required=True)
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--splits", default="val,test")
    args = p.parse_args(argv)

    os.makedirs(args.eval_data_dir, exist_ok=True)
    meta = {"max_seq_length": args.max_seq_length}
    for split in args.splits.split(","):
        meta.update(process_split(split, args.input_files, args.eval_data_dir))
    with open(os.path.join(args.eval_data_dir, "input_meta_data"), "w") as f:
        json.dump(meta, f, indent=4)
    print(json.dumps(meta, indent=2))


if __name__ == "__main__":
    main()
