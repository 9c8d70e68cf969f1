"""The port's preprocessing CLIs (``mmt_tpu_torch/preprocessing/``) against
the JAX package's (``mmt_tpu/preprocessing/``), case for case with
``tests/test_preprocessing.py`` and on its synthetic inputs.

Each CLI runs into one directory, its files are read, the directory is
emptied and the other package's CLI runs into the same directory (so
that the paths written into ``input_meta_data`` are the same); every file
must be byte-equal.  The Flickr30k records then feed the port's predict
CLI end to end.
"""

import csv
import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from mmt_tpu.preprocessing import fashion_gen as jax_fashion_gen
from mmt_tpu.preprocessing import flickr30k as jax_flickr30k
from mmt_tpu.preprocessing import wit as jax_wit
from mmt_tpu_torch.data.tfrecord import TFRecordReader, TFRecordWriter, build_example, parse_example
from mmt_tpu_torch.preprocessing import fashion_gen, flickr30k, wit
from tests.test_data_pipeline import png_bytes
from tests import test_preprocessing as jax_preprocessing_tests
from tests.test_preprocessing import paired_flickr_records

raw_pairs = jax_preprocessing_tests.TestFashionGenMetadata._raw_pairs


def _snapshot(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_files(out: Path, run_jax, run_port) -> dict:
    """Runs the JAX function, then the port's, into ``out``; asserts the
    files are byte-equal and returns them."""
    run_jax()
    want = _snapshot(out)
    shutil.rmtree(out)
    out.mkdir(parents=True)
    run_port()
    got = _snapshot(out)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert want
    return got


def _flickr_argv(tmp_path, out):
    return ["--input_files=" + str(tmp_path / "flickr30k.{}.recordio"),
            f"--eval_data_dir={out}", "--topk_images=3", "--splits=val"]


class TestFlickr30kAndWit:
    def test_builds_indices_and_meta(self, tmp_path):
        paired_flickr_records(str(tmp_path / "flickr30k.val.recordio"), 4,
                              np.random.default_rng(0))
        out = tmp_path / "out"
        argv = _flickr_argv(tmp_path, out)
        _same_files(out, lambda: jax_flickr30k.main(argv), lambda: flickr30k.main(argv))
        meta = json.loads((out / "input_meta_data").read_text())
        assert meta["val_num_image_examples"] == 3  # topk subsample
        assert meta["val_num_text_examples"] == 20  # 4 images x 5 captions
        texts = [parse_example(p) for p in TFRecordReader(meta["val_text_input_path"])]
        # Captions of the 4th image have gt -1 (image not in topk pool).
        gts = [t["gt_image_index"][0] for t in texts]
        assert gts[:15] == [0] * 5 + [1] * 5 + [2] * 5
        assert gts[15:] == [-1] * 5

    def test_wit_dedup(self, tmp_path):
        rng = np.random.default_rng(1)
        with TFRecordWriter(str(tmp_path / "wit.val.recordio")) as w:
            for doc, caption in [("a", "x"), ("a", "y"), ("b", "z"), ("a", "x")]:
                w.write(build_example({
                    "canonical_doc_id": [doc.encode()],
                    "image_data": [png_bytes(rng)],
                    "caption_attribution_description": [caption.encode()],
                }))
        out = tmp_path / "wout"
        argv = ["--input_files=" + str(tmp_path / "wit.{}.recordio"),
                f"--eval_data_dir={out}", "--splits=val"]
        _same_files(out, lambda: jax_wit.main(argv), lambda: wit.main(argv))
        meta = json.loads((out / "input_meta_data").read_text())
        assert meta["val_num_image_examples"] == 2  # a, b deduped
        assert meta["val_num_text_examples"] == 3  # duplicate (a, x) dropped

    def test_missing_split_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no files match"):
            flickr30k.main(_flickr_argv(tmp_path, tmp_path / "out"))


class TestPredictCli:
    def test_predict_cli_end_to_end(self, tmp_path):
        """The port's Flickr30k records + meta -> the port's predict CLI ->
        results.csv / recall.json."""
        import yaml

        from mmt_tpu_torch.cli import predict as cli_predict
        from mmt_tpu_torch.configs import get_experiment_config
        from mmt_tpu_torch.configs.base import from_yaml_file
        from mmt_tpu_torch.train.checkpoint import CheckpointManager
        from mmt_tpu_torch.train.tasks import ClassificationTask
        from tests.test_torch_predict_cli import VOCAB, _experiment_yaml

        paired_flickr_records(str(tmp_path / "flickr30k.val.recordio"), 4,
                              np.random.default_rng(0))
        out = tmp_path / "eval"
        flickr30k.main(_flickr_argv(tmp_path, out) + ["--max_seq_length=24"])
        (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
        config = _experiment_yaml(str(tmp_path / "vocab.txt"), "pallas")
        config["task"]["train_data"]["image_size"] = 64  # the records' PNGs
        config["task"]["model"]["encoder"]["mmt"]["max_absolute_position_embeddings"] = 64
        (tmp_path / "exp.yaml").write_text(yaml.safe_dump(config))
        cfg = from_yaml_file(get_experiment_config("mmt/classification"),
                             str(tmp_path / "exp.yaml"))
        task = ClassificationTask(cfg.task, cfg.trainer, device="cpu")
        CheckpointManager(str(tmp_path / "ckpt")).save(1, task.model)
        cli_predict.main([
            f"--config_file={tmp_path / 'exp.yaml'}",
            f"--input_meta_data_path={out / 'input_meta_data'}", "--predict_split=val",
            f"--init_checkpoint={tmp_path / 'ckpt'}", f"--test_output_dir={tmp_path / 'pred'}",
            "--predict_global_batch_size=8", "--device=cpu"])
        with open(tmp_path / "pred" / "results.csv") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 3 * 20  # the 3 pooled images x 20 captions
        assert {r["gt_image_index"] for r in rows} == {"0", "1", "2", "-1"}
        assert len(json.loads((tmp_path / "pred" / "recall.json").read_text())) == 8


def _info_file(path: Path, n: int):
    lines = ["\x01".join([f"main{i}", f"img{i}", "cat", "x", "subcat", "y",
                          f"description of product {i}"]) for i in range(n)]
    path.write_text("\n".join(lines) + "\n")


class TestFashionGenCandidates:
    def test_candidate_pools(self, tmp_path):
        info = tmp_path / "info.txt"
        _info_file(info, 40)
        want_path, got_path = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
        n = fashion_gen.build_candidates(str(info), "i2t", got_path, num_queries=5,
                                         pool_size=11, seed=1)
        assert n == jax_fashion_gen.build_candidates(str(info), "i2t", want_path,
                                                     num_queries=5, pool_size=11, seed=1)
        assert Path(got_path).read_bytes() == Path(want_path).read_bytes()
        df = pd.read_csv(got_path)
        assert len(df) == n and df["image_index"].nunique() == 5
        assert set(df.groupby("image_index").size()) <= {10, 11}
        hits = df[df["gt_image_index"] == df["image_index"]]
        assert hits.groupby("image_index").size().max() == 1

    def test_split_records(self, tmp_path):
        info = tmp_path / "info.txt"
        _info_file(info, 4)
        images = tmp_path / "imgs"
        images.mkdir()
        rng = np.random.default_rng(3)
        for i in (0, 2, 3):  # img1 has no image file: skipped
            (images / f"img{i}.png").write_bytes(png_bytes(rng))
        out = tmp_path / "out"
        out.mkdir()
        argv = ["split", f"--txt_info={info}", f"--images_dir={images}",
                f"--output={out / 'fg.train.recordio'}"]
        files = _same_files(out, lambda: jax_fashion_gen.main(argv),
                            lambda: fashion_gen.main(argv))
        assert len(list(TFRecordReader(str(out / "fg.train.recordio")))) == 3
        assert list(files) == ["fg.train.recordio"]


class TestFashionGenMetadata:
    """``metadata``: the port's csv/numpy version against the JAX package's
    pandas version on the pool-shape analog of ``tests/test_preprocessing.py``
    (4 pools of 6 candidates + 2 of 5, one i2t text with no gt anywhere)."""

    @pytest.mark.parametrize("task", ["i2t", "t2i"])
    def test_differential_vs_jax(self, tmp_path, task):
        pairs = raw_pairs(tmp_path, task)
        want_path, got_path = tmp_path / "jax.csv", tmp_path / "port.csv"
        want = jax_fashion_gen.build_metadata(pairs, task, str(want_path))
        got = fashion_gen.build_metadata(pairs, task, str(got_path))
        assert got_path.read_bytes() == want_path.read_bytes()
        assert len(got) == len(want)
        assert [r["gt_image_index"] for r in got] == want["gt_image_index"].tolist()

    @pytest.mark.parametrize("task", ["i2t", "t2i"])
    def test_empty_cells_and_missing_gt_vs_jax(self, tmp_path, task):
        """pandas' NaN rules: empty and "NA" cells, a t2i text without its
        gt (a float column), quoted descriptions with commas."""
        rows = [("p1", "0", "p1", 'red, "cotton" shirt'), ("p1", "0", "p2", ""),
                ("p2", "1", "p3", "NA"), ("", "0", "p2", "x"), ("p3", "", "p1", "y")]
        path = tmp_path / "raw.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["image_prod_id", "prod_img_id", "text_prod_id", "desc"])
            w.writerows(rows)
            f.write("\n")  # a blank last line, which both readers skip
        want_path, got_path = tmp_path / "jax.csv", tmp_path / "port.csv"
        jax_fashion_gen.build_metadata(str(path), task, str(want_path))
        fashion_gen.build_metadata(str(path), task, str(got_path))
        assert got_path.read_bytes() == want_path.read_bytes()

    @pytest.mark.parametrize("task", ["i2t", "t2i"])
    def test_numeric_extra_columns_vs_jax(self, tmp_path, task):
        """Extra columns typed as pandas' ``read_csv`` types them: a float
        column with an empty cell (JAX: ``0.5``, ``-1.0`` for i2t or empty
        for t2i, ``3.0``), an int column with padded cells, an all-empty
        column, booleans, exponents and infinities, an int beyond int64 (kept
        as text) and a numeric ``desc``."""
        header = ["image_prod_id", "prod_img_id", "text_prod_id", "desc", "score", "rank",
                  "empty", "flag", "exp", "huge"]
        rows = [("p1", "0", "p1", "1.50", "0.50", " 7", "", "true", "1e3", "99999999999999999999"),
                ("p1", "0", "p2", "2", "", "+4", "", "False", "-inf", "1"),
                ("p2", "1", "p2", "3", "3", "007", "", "TRUE", ".5", "2")]
        path = tmp_path / "raw.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(header)
            w.writerows(rows)
        want_path, got_path = tmp_path / "jax.csv", tmp_path / "port.csv"
        want = jax_fashion_gen.build_metadata(str(path), task, str(want_path))
        got = fashion_gen.build_metadata(str(path), task, str(got_path))
        assert got_path.read_bytes() == want_path.read_bytes()
        lines = got_path.read_text().splitlines()
        assert [line.split(",")[4] for line in lines[1:]] == \
            ["0.5", "-1.0" if task == "i2t" else "", "3.0"]
        assert [r["score"] for r in got][::2] == want["score"].tolist()[::2]

    def test_numeric_desc_feeds_retrieval_as_jax(self, tmp_path):
        """A candidates CSV whose ``desc`` cells are all numbers: the records'
        descriptions are ``str`` of pandas' values (``1.50`` -> ``1.5``)."""
        (tmp_path / "cands.csv").write_text(
            "image_id,desc,image_index,text_index,gt_image_index\n"
            "a_0,1.50,0,0,0\na_0,2,0,1,-1\nb_0,,1,0,0\n")
        info = tmp_path / "valid_info.txt"
        info.write_text("".join("\x01".join([p, f"{p}_0", "cat", "1", "sub", "2", "info"]) + "\n"
                                for p in ("a", "b")))
        img_dir = tmp_path / "imgs"
        img_dir.mkdir()
        rng = np.random.default_rng(5)
        for name in ("a_0", "b_0"):
            (img_dir / f"{name}.png").write_bytes(png_bytes(rng))
        out = tmp_path / "eval"
        out.mkdir()
        argv = ["retrieval", f"--txt_info={info}", f"--images_dir={img_dir}",
                f"--candidates_csv={tmp_path / 'cands.csv'}", "--task=t2i",
                f"--eval_data_dir={out}"]
        _same_files(out, lambda: jax_fashion_gen.main(argv), lambda: fashion_gen.main(argv))
        meta = json.loads((out / "t2i" / "input_meta_data").read_text())
        descs = [parse_example(p)["description"][0]
                 for p in TFRecordReader(meta["val_input_path"])]
        assert descs == [b"1.5", b"2.0", b"nan"]

    def test_pool_shape_and_gt_rules(self, tmp_path):
        i2t = pd.DataFrame(fashion_gen.build_metadata(
            raw_pairs(tmp_path, "i2t"), "i2t", str(tmp_path / "i.csv")))
        sizes = i2t["image_index"].value_counts()
        assert (sizes == 6).sum() == 4 and (sizes == 5).sum() == 2
        own = i2t[i2t["gt"] == 1]
        assert (own["gt_image_index"] == own["image_index"]).all()
        p10 = i2t[i2t["text_prod_id"] == "p10"]
        assert len(p10) == 1 and (p10["gt_image_index"] == -1).all()

        t2i = pd.DataFrame(fashion_gen.build_metadata(
            raw_pairs(tmp_path, "t2i"), "t2i", str(tmp_path / "t.csv")))
        sizes = t2i["text_index"].value_counts()
        assert (sizes == 6).sum() == 4 and (sizes == 5).sum() == 2
        assert t2i["gt_image_index"].notna().all()
        gt_rows = t2i[t2i["gt"] == 1]
        assert (gt_rows["gt_image_index"] == gt_rows["image_index"]).all()

    def test_feeds_retrieval_records(self, tmp_path):
        """metadata CSV -> build_retrieval -> records + meta, byte-equal to
        the JAX package's."""
        meta_csv = tmp_path / "i2t.csv"
        rows = fashion_gen.build_metadata(raw_pairs(tmp_path, "i2t"), "i2t", str(meta_csv))
        rng = np.random.default_rng(7)
        img_dir = tmp_path / "imgs"
        img_dir.mkdir()
        prods = {}
        for r in rows:
            prods.setdefault(r["image_id"], r["image_prod_id"])
        for image_id in sorted(prods):
            (img_dir / f"{image_id}.png").write_bytes(png_bytes(rng))
        info = tmp_path / "valid_info.txt"
        info.write_text("\n".join("\x01".join(
            [prod, image_id, "cat", "1", "sub", "2", f"info text {prod}"])
            for image_id, prod in sorted(prods.items())) + "\n")
        out = tmp_path / "eval"
        argv = ["retrieval", f"--txt_info={info}", f"--images_dir={img_dir}",
                f"--candidates_csv={meta_csv}", "--task=i2t", f"--eval_data_dir={out}"]
        out.mkdir()
        _same_files(out, lambda: jax_fashion_gen.main(argv), lambda: fashion_gen.main(argv))
        meta = json.loads((out / "i2t" / "input_meta_data").read_text())
        assert meta["val_num_examples"] == len(rows)
        parsed = [parse_example(p) for p in TFRecordReader(meta["val_input_path"])]
        got = {(p["image_index"][0], p["text_index"][0]): p["gt_image_index"][0]
               for p in parsed}
        assert got == {(r["image_index"], r["text_index"]): r["gt_image_index"] for r in rows}

    def test_metadata_cli(self, tmp_path, capsys):
        pairs = raw_pairs(tmp_path, "t2i")
        argv = ["metadata", f"--pairs_csv={pairs}", "--task=t2i"]
        jax_fashion_gen.main(argv + [f"--output_csv={tmp_path / 'jax.csv'}"])
        fashion_gen.main(argv + [f"--output_csv={tmp_path / 'port.csv'}"])
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].replace("jax.csv", "port.csv") == lines[1]


def test_records_helpers_match_jax():
    from mmt_tpu.preprocessing import records as jax_records
    from mmt_tpu_torch.preprocessing import records

    im = png_bytes(np.random.default_rng(5))
    assert records.image_example(im, {"k": b"v", "n": 3}, {"i": 7}) == \
        jax_records.image_example(im, {"k": b"v", "n": 3}, {"i": 7})
    assert records.text_example({"caption": "a b"}, {"t": -1}) == \
        jax_records.text_example({"caption": "a b"}, {"t": -1})
