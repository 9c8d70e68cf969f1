"""The port's predict CLI against the JAX package's prediction pieces.

The whole slice on the CPU: synthetic image and text records -> tokenizer
-> retrieval loader -> tiny model -> ``results.csv`` + ``recall.json``.
The JAX side initialises the parameters and scores the pairs in-process
(``mmt_tpu.cli.predict``'s pieces); the port gets the same parameters
through ``convert.params_from_flax`` and a torch checkpoint directory, and
runs ``mmt_tpu_torch.cli.predict.main`` with ``--device=cpu``.  Scores
must agree within 1e-4 (float32 models; the packages sum in different
orders) and ``recall.json`` must be equal.
"""

import csv
import io
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from mmt_tpu.cli.predict import build_retrieval_data_config as jax_build_retrieval_data_config
from mmt_tpu.configs import get_experiment_config as jax_get_experiment_config
from mmt_tpu.configs.base import from_yaml_file as jax_from_yaml_file
from mmt_tpu.data.loaders import MmtRetrievalLoader as JaxRetrievalLoader
from mmt_tpu.data.tfrecord import TFRecordWriter, build_example
from mmt_tpu.eval.predict import predict as jax_predict
from mmt_tpu.eval.predict import write_results as jax_write_results
from mmt_tpu.train.tasks import ClassificationTask as JaxClassificationTask
from mmt_tpu_torch.cli import predict as cli_predict
from mmt_tpu_torch.configs import TrainerConfig, get_experiment_config
from mmt_tpu_torch.configs.base import from_yaml_file, parse_params_override
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.tasks import ClassificationTask

WORDS = ["red", "blue", "shirt", "dress", "cotton", "wool", "style", "fashion"]
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[ATT]", "[REF]", "[PATCH]"]
    + [f"[unused{i}]" for i in range(99, 120)]
    + WORDS
)
NUM_IMAGES, NUM_TEXTS, BATCH = 3, 6, 8


def _png(rng, size=32):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _experiment_yaml(vocab, attention_impl):
    return {"task": {
        "model": {
            "encoder": {"type": "mmt", "mmt": dict(
                vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64, relative_pos_max_distance=3,
                relative_vocab_size=12, relative_att_num_core_layers=1,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                compute_dtype="float32", attention_impl=attention_impl,
                max_absolute_position_embeddings=40)},
            "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}],
            "num_classes": 2},
        "train_data": dict(
            vocab_filename=vocab, image_size=32, patch_size=16, max_seq_len=24,
            text_special_token_field_dict='{"caption": "[ATT]"}',
            relative_pos_max_distance=3, relative_att_num_core_layers=1)}}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Records, vocab, meta data and the two yamls (the JAX one runs its
    Pallas kernel in interpret mode, which is its CPU route)."""
    root = tmp_path_factory.mktemp("predict_cli")
    rng = np.random.default_rng(0)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    with TFRecordWriter(str(root / "img.tfrecord")) as w:
        for i in range(NUM_IMAGES):
            w.write(build_example({"image_data": [_png(rng)], "image_key": [f"img{i}".encode()],
                                   "image_index": [i]}))
    with TFRecordWriter(str(root / "txt.tfrecord")) as w:
        for t in range(NUM_TEXTS):
            caption = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 20))))
            w.write(build_example({"caption": [caption.encode()], "text_index": [t],
                                   "gt_image_index": [t // 2]}))
    meta = {"max_seq_length": 32,
            "test_image_input_path": str(root / "img.tfrecord"),
            "test_text_input_path": str(root / "txt.tfrecord"),
            "test_num_image_examples": NUM_IMAGES, "test_num_text_examples": NUM_TEXTS}
    (root / "meta.json").write_text(json.dumps(meta))
    for name, impl in (("torch.yaml", "pallas"), ("jax.yaml", "pallas_interpret")):
        (root / name).write_text(yaml.safe_dump(_experiment_yaml(str(vocab), impl)))
    return root


def _jax_reference(workdir, out_dir):
    """``mmt_tpu.cli.predict.main`` without the checkpoint: writes the JAX
    results to ``out_dir``; returns the Flax parameters, the recall dict,
    the experiment config and the task."""
    import dataclasses

    cfg = jax_from_yaml_file(jax_get_experiment_config("mmt/classification"),
                             str(workdir / "jax.yaml"), strict=True)
    meta = json.loads((workdir / "meta.json").read_text())
    data_cfg = jax_build_retrieval_data_config(cfg.task.train_data, meta, "test", BATCH)
    task = JaxClassificationTask(dataclasses.replace(cfg.task, train_data=data_cfg), cfg.trainer)
    loader = JaxRetrievalLoader(data_cfg)
    params = task.init(jax.random.PRNGKey(0), next(iter(loader.load())))
    recall = jax_write_results(
        jax_predict(task.make_inference_step(), params, loader.load()), str(out_dir))
    return params, recall, cfg, task


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _torch_args(workdir, ckpt, out_dir, *extra):
    return [f"--config_file={workdir / 'torch.yaml'}",
            f"--input_meta_data_path={workdir / 'meta.json'}", "--predict_split=test",
            f"--init_checkpoint={ckpt}", f"--test_output_dir={out_dir}",
            f"--predict_global_batch_size={BATCH}", "--device=cpu", *extra]


def test_predict_cli_matches_jax(workdir, tmp_path, capsys):
    params, want_recall, jax_cfg, _ = _jax_reference(workdir, tmp_path / "jax")
    params = jax.tree_util.tree_map(np.asarray, params)

    cfg = from_yaml_file(get_experiment_config("mmt/classification"),
                         str(workdir / "torch.yaml"))
    meta = json.loads((workdir / "meta.json").read_text())
    data_cfg = cli_predict.build_retrieval_data_config(cfg.task.train_data, meta, "test", BATCH)
    want_data = jax_build_retrieval_data_config(jax_cfg.task.train_data, meta, "test", BATCH)
    assert data_cfg.as_dict() == want_data.as_dict()
    task = ClassificationTask(cfg.task, cfg.trainer, device="cpu")
    task.model.load_state_dict(params_from_flax(params, task.model))
    ckpt = tmp_path / "ckpt"
    CheckpointManager(str(ckpt)).save(7, task.model)

    cli_predict.main(_torch_args(workdir, ckpt, tmp_path / "torch"))
    printed = json.loads(capsys.readouterr().out)
    got_recall = json.loads((tmp_path / "torch" / "recall.json").read_text())
    assert printed == got_recall == want_recall
    assert len(got_recall) == 8

    got, want = _rows(tmp_path / "torch" / "results.csv"), _rows(tmp_path / "jax" / "results.csv")
    assert len(got) == len(want) == NUM_IMAGES * NUM_TEXTS
    for g, w in zip(got, want):
        assert [g[k] for k in ("image_index", "text_index", "gt_image_index")] == \
            [w[k] for k in ("image_index", "text_index", "gt_image_index")]
        assert abs(float(g["output"]) - float(w["output"])) <= 1e-4
        assert 0.0 <= float(g["output"]) <= 1.0 and len(g["output"].split(".")[1]) == 8
    assert len({g["output"] for g in got}) > 1  # the scores depend on the pair


def test_predict_cli_raw_images_match_host_patches(workdir, tmp_path):
    """``ship_raw_images``: the encoder's ``images`` input (patches made on
    the model's device) against JAX's same path and against host patches."""
    params, _, _, jax_task = _jax_reference(workdir, tmp_path / "jax")
    cfg = from_yaml_file(get_experiment_config("mmt/classification"),
                         str(workdir / "torch.yaml"))
    task = ClassificationTask(cfg.task, cfg.trainer, device="cpu")
    task.model.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params), task.model))

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    from mmt_tpu_torch.features.patches import extract_patches, normalize_image

    host = extract_patches(normalize_image(np.true_divide(images, 255, dtype=np.float32)), 16)
    batch = dict(word_ids=rng.integers(0, len(VOCAB), (2, 24)).astype(np.int32),
                 lengths=np.asarray([24, 13], np.int32))
    step = task.make_inference_step()
    from_images = step({**batch, "images": images}).numpy()
    from_patches = step({**batch, "patch_embeddings": host}).numpy()
    np.testing.assert_allclose(from_images, from_patches, atol=1e-6)
    jax_scores = np.asarray(jax_task.make_inference_step()(params, {**batch, "images": images}))
    np.testing.assert_allclose(from_images, jax_scores, atol=1e-4)
    with torch.no_grad():
        on_device = extract_patches(normalize_image(torch.from_numpy(images).float() / 255.0), 16)
    np.testing.assert_allclose(on_device.numpy(), host, atol=1e-6)


def test_missing_checkpoint_names_the_path(workdir, tmp_path):
    empty = tmp_path / "no_ckpt"
    with pytest.raises(FileNotFoundError, match=str(empty)):
        cli_predict.main(_torch_args(workdir, empty, tmp_path / "out"))
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match=str(empty)):
        CheckpointManager(str(empty)).restore()
    assert CheckpointManager(str(empty)).latest_step() is None


@pytest.mark.parametrize("flag", ["--export_serving_artifact=/tmp/x", "--export_bucket_sizes=1,8"])
def test_export_flags_raise(workdir, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="Slice D"):
        cli_predict.main(_torch_args(workdir, tmp_path / "ckpt", tmp_path / "out", flag))


def test_default_device_is_the_card(workdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _torch_args(workdir, tmp_path / "ckpt", tmp_path / "out")
            if a != "--device=cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_predict.main(args)
    assert not (tmp_path / "out").exists()


def test_checkpoint_round_trip(tmp_path):
    model = torch.nn.Linear(3, 2)
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert mgr.latest_step() is None
    mgr.save(2, model)
    with torch.no_grad():
        model.weight.add_(1.0)
    mgr.save(10, model)
    assert mgr.latest_step() == 10
    torch.testing.assert_close(mgr.restore()["weight"], model.weight, rtol=0, atol=0)
    torch.testing.assert_close(mgr.restore(2)["weight"], model.weight - 1.0)
    with pytest.raises(FileNotFoundError):
        mgr.restore(3)


def test_classification_task_inference_side_only(workdir):
    cfg = from_yaml_file(get_experiment_config("mmt/classification"),
                         str(workdir / "torch.yaml"))
    task = ClassificationTask(cfg.task, TrainerConfig(), device="cpu")
    assert (task.logits_key, task.num_classes) == ("itm_logits", 2)
    for method in (task.compute_loss, task.make_train_step, task.make_eval_step):
        with pytest.raises(NotImplementedError, match="not ported"):
            method()
    no_heads = parse_params_override(cfg, '{"task": {"model": {"cls_heads": []}}}')
    with pytest.raises(ValueError, match="cls_heads is empty"):
        ClassificationTask(no_heads.task, TrainerConfig(), device="cpu")


@pytest.mark.parametrize("num_classes,want", [
    (1, lambda x: 1 / (1 + np.exp(-x.reshape(-1)))),
    (2, lambda x: np.exp(x[:, 1]) / np.exp(x).sum(-1)),
    (3, lambda x: x.argmax(-1).astype(np.float32)),
])
def test_scores_from_logits(num_classes, want):
    from mmt_tpu_torch.eval.predict import scores_from_logits

    logits = np.random.default_rng(num_classes).normal(size=(5, num_classes)).astype(np.float32)
    got = scores_from_logits(torch.from_numpy(logits), num_classes).numpy()
    np.testing.assert_allclose(got, want(logits), rtol=1e-6)


def test_configs_parse_json_without_pyyaml(tmp_path, monkeypatch):
    """On a machine without pyyaml a JSON config file and override load to
    the same values."""
    import sys

    overrides = {"task": {"train_data": {"max_seq_len": 64, "vocab_filename": "v.txt"}}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(overrides))
    want = from_yaml_file(get_experiment_config("mmt/classification"), str(path))
    want = parse_params_override(want, "trainer.train_steps=5,task.metric_type=auc")
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    got = from_yaml_file(get_experiment_config("mmt/classification"), str(path))
    got = parse_params_override(got, "trainer.train_steps=5,task.metric_type=auc")
    assert got.as_dict() == want.as_dict()
    assert got.trainer.train_steps == 5 and got.task.metric_type == "auc"
    assert parse_params_override(got, json.dumps(overrides)).as_dict() == got.as_dict()
