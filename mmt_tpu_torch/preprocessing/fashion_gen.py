"""Fashion-Gen preprocessing: train/val splits + retrieval test sets.

The port's copy of ``mmt_tpu/preprocessing/fashion_gen.py``, without
pandas: ``build_metadata`` and ``build_retrieval`` read and write their CSVs
with ``csv``, typing each column as pandas' ``read_csv`` infers it and
writing it back as ``to_csv(index=False)`` does (the same bytes for the
same inputs).

Parity: ``preprocessing/create_fashion_gen_split.py`` (paired records
from \\x01-separated info files + extracted images) and
``preprocessing/create_fashion_gen_retrieval_test_data.py`` (i2t/t2i
candidate pools from Fashion-BERT/Kaleido-BERT CSVs: each row is one
scored pair carrying image_index/text_index/gt_image_index; gt -1 when
the ground truth is absent from the pool).

Usage:
  # candidate-pool CSV from a raw Fashion-BERT/Kaleido-BERT pairs file
  # (columns: image_prod_id, prod_img_id, text_prod_id, desc)
  python -m mmt_tpu_torch.preprocessing.fashion_gen metadata \
      --pairs_csv=fashion_gen_i2t_test_pairs.csv --task=i2t \
      --output_csv=fashion_bert_i2t_test.csv

  # paired split records
  python -m mmt_tpu_torch.preprocessing.fashion_gen split \
      --txt_info=full_train_info.txt --images_dir=imgs --output=fg.train.recordio

  # retrieval test data from candidate csv (columns: image_id, desc,
  # image_index, text_index, gt_image_index)
  python -m mmt_tpu_torch.preprocessing.fashion_gen retrieval \
      --txt_info=full_valid_info.txt --images_dir=imgs \
      --candidates_csv=fashion_bert_i2t_test.csv --task=i2t \
      --eval_data_dir=/out
"""

from __future__ import annotations

import argparse
import collections
import csv
import json
import os
import re

from mmt_tpu_torch.data.tfrecord import TFRecordWriter
from mmt_tpu_torch.preprocessing.records import get_txt_info, image_example

# pandas' default ``na_values``: read_csv makes these cells NaN.
_NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"])
_ADDED_COLUMNS = ["image_id", "text_index", "image_index", "gt", "gt_image_index"]
_ID_COLUMNS = ("image_prod_id", "prod_img_id", "text_prod_id")  # read as text
# The cells pandas' C parser reads as int64 and as float64.
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*",
                    re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


def _read_csv(path):
    """(header, rows): each row a dict of its cells, None where pandas'
    ``read_csv`` reads NaN; blank lines skipped, as pandas skips them."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [dict(zip(header, (None if v in _NA_STRINGS else v for v in cells)))
                for cells in reader if cells]
    return header, rows


def _infer_column(cells):
    """(kind, values) of a column of cells (None where pandas reads NaN) as
    ``read_csv`` types it: "int" (every cell an int64, or a uint64), "float"
    (every cell a number, or an int with NaN cells, or every cell NaN; NaN
    stays None), "bool" or "text" (the cells as read).  A decimal with more
    than 15 significant digits may round otherwise than pandas' parser."""
    present = [c for c in cells if c is not None]
    if present and all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        if not (all(-2 ** 63 <= v < 2 ** 63 for v in ints) or all(0 <= v < 2 ** 64 for v in ints)):
            return "text", cells  # pandas keeps such a column as objects
        if len(present) == len(cells):
            return "int", [int(c) for c in cells]
    if all(_FLOAT.fullmatch(c) for c in present):
        return "float", [None if c is None else float(c) for c in cells]
    if all(c in _BOOLS for c in present):
        return "bool", [None if c is None else _BOOLS[c] for c in cells]
    return "text", cells


def _type_columns(rows, columns):
    """Replaces the cells of ``columns`` in ``rows`` by their typed values;
    returns {column: kind}."""
    kinds = {}
    for c in columns:
        kinds[c], values = _infer_column([r.get(c) for r in rows])
        for r, v in zip(rows, values):
            r[c] = v
    return kinds


def _csv_cell(value) -> str:
    """``to_csv``'s text of a value: NaN empty, floats by ``repr``."""
    if value is None:
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def _category_codes(values):
    """pandas ``.astype("category").cat.codes``: the rank among the sorted
    unique values; -1 for NaN."""
    rank = {v: i for i, v in enumerate(sorted({v for v in values if v is not None}))}
    return [-1 if v is None else rank[v] for v in values]


def build_split(txt_info_path, images_dir, output_path, image_ext="png"):
    txt_info = get_txt_info(txt_info_path)
    n = 0
    with TFRecordWriter(output_path) as w:
        for image_id, string_dict in txt_info.items():
            img_path = os.path.join(images_dir, f"{image_id}.{image_ext}")
            if not os.path.exists(img_path):
                continue
            with open(img_path, "rb") as f:
                im = f.read()
            w.write(image_example(im, string_dict))
            n += 1
    return n


def build_retrieval(
    txt_info_path, images_dir, candidates_csv, task, eval_data_dir,
    image_ext="png", max_seq_length=512,
):
    txt_info = get_txt_info(txt_info_path, description_key="original_description")
    _, rows = _read_csv(candidates_csv)
    _type_columns(rows, ["desc"])
    out_dir = os.path.join(eval_data_dir, task)
    os.makedirs(out_dir, exist_ok=True)
    record_path = os.path.join(out_dir, f"fashion_gen.{task}.valid.recordio-00000-of-00001")
    with TFRecordWriter(record_path) as w:
        for row in rows:
            image_id = row["image_id"]
            string_dict = dict(txt_info[image_id])
            # The candidate CSV's description may differ slightly from the
            # info file; the CSV's text is authoritative for scoring (``str``
            # of pandas' value: a NaN cell reads "nan", a numeric column's
            # cells as numbers).
            desc = row["desc"]
            string_dict["description"] = ("nan" if desc is None else str(desc)).encode()
            with open(os.path.join(images_dir, f"{image_id}.{image_ext}"), "rb") as f:
                im = f.read()
            w.write(
                image_example(
                    im,
                    string_dict,
                    {
                        "image_index": int(row["image_index"]),
                        "text_index": int(row["text_index"]),
                        "gt_image_index": int(row["gt_image_index"]),
                    },
                )
            )
    meta = {
        "processor_type": "fashion_gen",
        "max_seq_length": max_seq_length,
        "task_type": "mmt_retrieval",
        "val_input_path": record_path,
        "val_num_examples": len(rows),
    }
    with open(os.path.join(out_dir, "input_meta_data"), "w") as f:
        json.dump(meta, f, indent=4)
    return meta


def build_metadata(pairs_csv, task, output_csv):
    """Builds the i2t/t2i candidate CSV from a raw Fashion-BERT/Kaleido-BERT
    pool file (metadata-notebook parity); returns its rows (dicts of the
    typed values, None where the CSV has an empty cell).

    Parity: ``preprocessing/create_fashion_gen_metadata.ipynb`` (cells
    5-11).  Input columns: ``image_prod_id``, ``prod_img_id``,
    ``text_prod_id``, ``desc`` (one row per scored image-text pair; a
    product has one description and possibly several images).  Adds:

    * ``image_id``   = ``image_prod_id + '_' + prod_img_id``
    * ``text_index`` = pandas categorical codes of ``text_prod_id``
      (i.e. rank in the sorted unique values — faithful to
      ``.astype('category').cat.codes``)
    * ``image_index`` = categorical codes of ``image_id``
    * ``gt`` = 1 where ``image_prod_id == text_prod_id``
    * ``gt_image_index`` via a left merge of the gt rows on
      ``text_index``; for i2t, texts whose ground-truth image is absent
      from the pool get −1 (``fillna(-1)``, which fills every empty cell,
      then int cast); for t2i the notebook asserts every text has its gt
      present and does neither (faithful — a missing t2i gt would surface
      as a float/NaN column exactly as upstream).

    Faithful quirk: a text with several gt rows (multiple images of its
    own product in the pool) is row-duplicated by the merge, as
    upstream.  Output keeps every input column plus the added ones, so
    it feeds ``build_retrieval`` (which needs image_id/desc/indices)
    directly.  Every column but the three ids is typed as ``read_csv``
    types it (``_infer_column``) and written back as ``to_csv`` writes it:
    a numeric column with an empty cell is float64 (``0.50`` and ``3``
    come back as ``0.5`` and ``3.0``), and for i2t its NaN cells are filled
    with ``-1.0``, other columns' with ``-1``.
    """
    header, rows = _read_csv(pairs_csv)
    kinds = _type_columns(rows, [c for c in header if c not in _ID_COLUMNS])
    for r in rows:
        parts = (r["image_prod_id"], r["prod_img_id"])
        r["image_id"] = None if None in parts else "_".join(parts)
    text_index = _category_codes([r["text_prod_id"] for r in rows])
    image_index = _category_codes([r["image_id"] for r in rows])
    gt_images = collections.defaultdict(list)  # text_index -> gt rows' image_index
    for r, t, i in zip(rows, text_index, image_index):
        r["text_index"], r["image_index"] = t, i
        r["gt"] = int(r["image_prod_id"] is not None
                      and r["image_prod_id"] == r["text_prod_id"])
        if r["gt"]:
            gt_images[t].append(i)
    out = [{**r, "gt_image_index": g} for r in rows
           for g in gt_images.get(r["text_index"], [None])]
    if task == "i2t":
        out = [{k: (-1.0 if kinds.get(k) == "float" else -1) if v is None else v
                for k, v in r.items()} for r in out]
    # A t2i text without its gt makes pandas' merged column float.
    as_float = task == "t2i" and any(r["gt_image_index"] is None for r in out)
    columns = header + [c for c in _ADDED_COLUMNS if c not in header]
    with open(output_csv, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for r in out:
            cells = [_csv_cell(r[c]) for c in columns]
            if as_float and r["gt_image_index"] is not None:
                cells[columns.index("gt_image_index")] = repr(float(r["gt_image_index"]))
            writer.writerow(cells)
    return out


def build_candidates(
    txt_info_path, task, output_csv, num_queries=1000, pool_size=101, seed=0,
    gt_dropout=0.011,
):
    """Builds an i2t/t2i candidate-pool CSV (metadata-notebook parity).

    Reference pools (Fashion-BERT/Kaleido-BERT style): ``num_queries``
    queries, each scored against ``pool_size`` candidates containing the
    ground truth (a small fraction of pools lack it -> gt_image_index
    -1, exercised by the recall code's missing-gt path).  Columns match
    ``create_fashion_gen_retrieval_test_data.py``: image_id, desc,
    image_index, text_index, gt_image_index.
    """
    import numpy as np

    info = get_txt_info(txt_info_path)
    image_ids = sorted(info)
    rng = np.random.default_rng(seed)
    queries = rng.choice(len(image_ids), size=min(num_queries, len(image_ids)),
                         replace=False)

    # A "product" is one (image, description) pair keyed by image_id.
    # Rows pair the query product's image (i2t) or text (t2i) with each
    # candidate product's text/image.
    pairs = []  # (image_product, text_product)
    for q in queries:
        qid = image_ids[q]
        drop_gt = rng.random() < gt_dropout
        others = rng.choice(len(image_ids), size=pool_size + 1, replace=False)
        pool = [image_ids[o] for o in others if image_ids[o] != qid]
        pool = pool[: pool_size - (0 if drop_gt else 1)]
        if not drop_gt:
            pool.append(qid)
        rng.shuffle(pool)
        for cand in pool:
            pairs.append((qid, cand) if task == "i2t" else (cand, qid))

    image_index, text_index = {}, {}
    for img, txt in pairs:
        image_index.setdefault(img, len(image_index))
        text_index.setdefault(txt, len(text_index))

    rows = [
        dict(
            image_id=img,
            desc=info[txt]["description"].decode("utf-8", "replace"),
            image_index=image_index[img],
            text_index=text_index[txt],
            # A text's true image is its own product's image; -1 when that
            # image does not appear in this pool file.
            gt_image_index=image_index.get(txt, -1),
        )
        for img, txt in pairs
    ]

    with open(output_csv, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["image_id", "desc", "image_index", "text_index",
                           "gt_image_index"]
        )
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("split")
    ps.add_argument("--txt_info", required=True)
    ps.add_argument("--images_dir", required=True)
    ps.add_argument("--output", required=True)
    ps.add_argument("--image_ext", default="png")

    pm = sub.add_parser("metadata")
    pm.add_argument("--pairs_csv", required=True)
    pm.add_argument("--task", choices=["i2t", "t2i"], required=True)
    pm.add_argument("--output_csv", required=True)

    pc = sub.add_parser("candidates")
    pc.add_argument("--txt_info", required=True)
    pc.add_argument("--task", choices=["i2t", "t2i"], required=True)
    pc.add_argument("--output_csv", required=True)
    pc.add_argument("--num_queries", type=int, default=1000)
    pc.add_argument("--pool_size", type=int, default=101)
    pc.add_argument("--seed", type=int, default=0)

    pr = sub.add_parser("retrieval")
    pr.add_argument("--txt_info", required=True)
    pr.add_argument("--images_dir", required=True)
    pr.add_argument("--candidates_csv", required=True)
    pr.add_argument("--task", choices=["i2t", "t2i"], required=True)
    pr.add_argument("--eval_data_dir", required=True)
    pr.add_argument("--image_ext", default="png")
    pr.add_argument("--max_seq_length", type=int, default=512)

    args = p.parse_args(argv)
    if args.cmd == "split":
        n = build_split(args.txt_info, args.images_dir, args.output, args.image_ext)
        print(f"wrote {n} examples to {args.output}")
    elif args.cmd == "metadata":
        df = build_metadata(args.pairs_csv, args.task, args.output_csv)
        print(f"wrote {len(df)} candidate pairs to {args.output_csv}")
    elif args.cmd == "candidates":
        n = build_candidates(
            args.txt_info, args.task, args.output_csv,
            num_queries=args.num_queries, pool_size=args.pool_size, seed=args.seed,
        )
        print(f"wrote {n} candidate pairs to {args.output_csv}")
    else:
        meta = build_retrieval(
            args.txt_info, args.images_dir, args.candidates_csv, args.task,
            args.eval_data_dir, args.image_ext, args.max_seq_length,
        )
        print(json.dumps(meta, indent=2))


if __name__ == "__main__":
    main()
