"""The port's finetuning path (ITM classification) against the JAX package's.

Inputs come from numpy seeds; the JAX side runs on the CPU with its dense
attention (``xla``), the port with ``--device=cpu`` (the fused op's plain
version).  Tolerances:

* matching features, every RandAugment op (several seeds, images from
  uint8), ``MmtClassificationLoader`` batches with rand-aug on and off and
  ``is_training`` on and off: equal;
* the eval split's last, partial batch (``drop_remainder`` false): equal to
  JAX's ``_finalize`` of the same examples (the JAX loader drops it);
* ``TrainStream`` ``state()`` / ``restore()``: the resumed stream equal to
  the uninterrupted one;
* ``auc_pr``: 1e-12 of JAX's on random inputs; the Keras goldens of
  ``tests/test_metrics.py`` at 2e-5;
* ``ClassificationTask.compute_loss`` loss and metrics, 1 and 2 classes
  with ``pos_weights``: 1e-5; the eval step's probabilities: 1e-5; three
  AdamW train steps with dropout 0: each parameter tensor within 1e-5 of
  its norm (float32 through 2 layers, sums in another order);
* the CLI on the CPU (``train_and_eval`` and ``eval``): the files JAX's CLI
  writes, and, as the slice as a whole, the validation ``cls_accuracy``,
  ``cls_loss`` and ``auc`` of 4 steps with dropout 0 within 1e-4 of JAX's
  CLI on the same records from the same parameters.
"""

import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from mmt_tpu.configs import ClassificationTaskConfig as JaxTaskConfig
from mmt_tpu.configs import TrainerConfig as JaxTrainerConfig
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.configs.data import MmtClassificationDataConfig as JaxDataConfig
from mmt_tpu.data import rand_augment as jax_rand_augment
from mmt_tpu.data.loaders import MmtClassificationLoader as JaxLoader
from mmt_tpu.data.tfrecord import TFRecordWriter, build_example
from mmt_tpu.eval.metrics_host import auc_pr as jax_auc_pr
from mmt_tpu.features import matching as jax_matching
from mmt_tpu.train import optimizer as jax_optimizer
from mmt_tpu.train.tasks import ClassificationTask as JaxTask
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.configs import ClassificationTaskConfig, TrainerConfig, override
from mmt_tpu_torch.configs.data import MmtClassificationDataConfig
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.data import rand_augment
from mmt_tpu_torch.data.loaders import MmtClassificationLoader, ResumablePrefixed
from mmt_tpu_torch.eval.metrics_host import auc_pr
from mmt_tpu_torch.features import matching
from mmt_tpu_torch.train.optimizer import create_optimizer
from mmt_tpu_torch.train.tasks import ClassificationTask, batch_to_device
from mmt_tpu_torch.train.train_state import TrainState

WORDS = ["red", "blue", "shirt", "dress", "cotton", "wool", "style", "fashion"]
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[ATT]", "[REF]", "[PATCH]"]
    + [f"[unused{i}]" for i in range(99, 120)]
    + WORDS
)
S = 32  # image 32 / patch 16: [CLS] [PATCH] 4 patches, then text
ENCODER = dict(
    vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, relative_pos_max_distance=3, relative_vocab_size=12,
    relative_att_num_core_layers=1, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0, compute_dtype="float32",
    max_absolute_position_embeddings=40)


def _png(rng, size=32):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def write_paired_records(path, n, seed=0):
    """Flickr30k-style paired records: two captions per image key."""
    rng = np.random.default_rng(seed)
    with TFRecordWriter(str(path)) as w:
        for i in range(n):
            caption = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
            w.write(build_example({"image_data": [_png(rng)],
                                   "image_key": [f"img{i // 2}".encode()],
                                   "caption": [caption.encode()]}))
    return str(path)


def write_vocab(root):
    path = root / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


def data_dict(vocab, input_path, **kw):
    base = dict(vocab_filename=vocab, input_path=input_path, image_size=32, patch_size=16,
                max_seq_len=S, seed=7, global_batch_size=32, negative_positive_ratio=3,
                min_shift=2, pos_weight=2.0, shuffle_buffer_size=12,
                text_special_token_field_dict='{"caption": "[ATT]"}',
                relative_pos_max_distance=3, relative_att_num_core_layers=1)
    base.update(kw)
    return base


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k


def take(stream, n):
    return [next(stream) for _ in range(n)]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune_records")
    return {"root": root, "vocab": write_vocab(root),
            "train": write_paired_records(root / "train.tfrecord", 40, seed=0),
            "val": write_paired_records(root / "val.tfrecord", 24, seed=1)}


# ------------------------------------------------------------ host pieces


@pytest.mark.parametrize("ratio", [1, 3])
def test_matching_features_match(ratio):
    rng = np.random.default_rng(ratio)
    n = 9
    feats = {
        "patch_token_ids": rng.integers(0, 50, (n, 6)).astype(np.int32),
        "patch_embeddings": rng.normal(size=(n, 4, 5)).astype(np.float32),
        "num_image_wordpieces": np.full((n,), 6, np.int32),
        "text_token_ids": rng.integers(0, 50, (n, 7)).astype(np.int32),
        "num_text_wordpieces": rng.integers(1, 7, n).astype(np.int32),
        "other": rng.normal(size=(n, 2)),
    }
    for keys in ([f"k{i % 4}".encode() for i in range(n)], [i % 3 for i in range(n)],
                 [np.asarray([i % 2, 1]) for i in range(n)]):
        np.testing.assert_array_equal(matching._first_occurrence_ids(keys),
                                      jax_matching._first_occurrence_ids(keys))
        got = matching.make_matching_features(feats, keys, ratio, min_shift=1)
        want = jax_matching.make_matching_features(feats, keys, ratio, min_shift=1)
        assert_batches_equal([got], [want])
    for bad in (dict(negative_positive_ratio=ratio, min_shift=n), dict(negative_positive_ratio=0)):
        with pytest.raises(ValueError):
            matching.make_matching_features(feats, list(range(n)), **bad)


@pytest.mark.parametrize("op", rand_augment.RandAugment.OPS)
def test_rand_augment_op_matches(op):
    ops, jax_ops = rand_augment.build_ops(), jax_rand_augment.build_ops()
    assert sorted(ops) == sorted(jax_ops) == sorted(rand_augment.RandAugment.OPS)
    for seed in range(3):
        u8 = np.random.default_rng(seed).integers(0, 256, (24, 24, 3), dtype=np.uint8)
        im = u8.astype(np.float32) / 255.0
        got = ops[op](im, 10.0, np.random.default_rng(100 + seed))
        want = jax_ops[op](im, 10.0, np.random.default_rng(100 + seed))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_rand_augment_draws_match():
    for seed in range(6):
        im = np.random.default_rng(seed).integers(0, 256, (16, 16, 3)).astype(np.float32) / 255
        got = rand_augment.RandAugment(num_layers=2)(im, np.random.default_rng(seed))
        want = jax_rand_augment.RandAugment(num_layers=2)(im, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_training,rand_aug", [(True, True), (True, False),
                                                  (False, True), (False, False)])
def test_classification_loader_batches_match(records, is_training, rand_aug):
    kw = data_dict(records["vocab"], records["train"], is_training=is_training,
                   use_rand_aug=rand_aug)
    got = take(MmtClassificationLoader(MmtClassificationDataConfig(**kw)).load(), 3)
    want = take(JaxLoader(JaxDataConfig(**kw)).load(), 3)
    assert_batches_equal(got, want)
    b = got[0]
    assert b["word_ids"].shape == (32, S) and b["patch_embeddings"].shape == (32, 4, 768)
    assert set(np.unique(b["pos_weights"])) == {1.0, 2.0}
    np.testing.assert_array_equal(b["pos_weights"] == 2.0, b["label_ids"] == 1)


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_eval_split_last_partial_batch(records, tmp_path, drop_remainder):
    """23 records, 8 a matched batch: 2 full batches and, unless
    drop_remainder, a partial one of 7 x 4 rows."""
    path = write_paired_records(tmp_path / "odd.tfrecord", 23, seed=3)
    kw = data_dict(records["vocab"], path, is_training=False, drop_remainder=drop_remainder)
    got = list(MmtClassificationLoader(MmtClassificationDataConfig(**kw)).load())
    want = list(JaxLoader(JaxDataConfig(**kw)).load())  # the JAX loader drops the partial
    assert len(want) == 2
    assert_batches_equal(got[:2], want)
    assert len(got) == 2 + (not drop_remainder)
    if not drop_remainder:
        jax_loader = JaxLoader(JaxDataConfig(**kw))
        from mmt_tpu.data.tfrecord import TFRecordReader

        tail = list(TFRecordReader(path))[16:]
        examples, keys = [], []
        for payload in tail:
            ex = jax_loader._decode(payload, None, False)
            examples.append(jax_loader._features(ex))
            keys.append(ex.extras["image_key"])
        assert_batches_equal(got[2:], [jax_loader._finalize(examples, keys)])
        assert got[2]["word_ids"].shape == (28, S)


def test_train_stream_resume_exact(records):
    cfg = MmtClassificationDataConfig(**data_dict(
        records["vocab"], records["train"], is_training=True, use_rand_aug=True,
        global_batch_size=16, negative_positive_ratio=1, min_shift=1))
    want = take(MmtClassificationLoader(cfg).stream(), 12)
    jax_want = take(JaxLoader(JaxDataConfig(**cfg.as_dict())).stream(), 12)
    assert_batches_equal(want, jax_want)
    run1 = MmtClassificationLoader(cfg).stream()
    take(run1, 7)
    st = pickle.loads(pickle.dumps(run1.state()))
    run2 = MmtClassificationLoader(cfg).stream()  # a fresh process's loader
    run2.restore(st)
    assert_batches_equal(take(run2, 5), want[7:])

    primed = ResumablePrefixed(MmtClassificationLoader(cfg).stream())
    first = primed.prime()
    assert_batches_equal([first], want[:1])
    before = pickle.dumps(primed.state())  # the position before the pulled batch
    assert_batches_equal(take(primed, 3), want[:3])
    again = ResumablePrefixed(MmtClassificationLoader(cfg).stream())
    again.prime()
    again.restore(pickle.loads(before))
    assert_batches_equal(take(again, 2), want[:2])


def test_auc_pr_matches():
    rng = np.random.default_rng(0)
    for n in (1, 7, 300):
        labels = rng.integers(0, 2, n)
        probs = rng.random(n)
        for weights in (None, rng.random(n)):
            np.testing.assert_allclose(auc_pr(labels, probs, weights),
                                       jax_auc_pr(labels, probs, weights), rtol=0, atol=1e-12)
    # tests/test_metrics.py's goldens from tf.keras.metrics.AUC(curve='PR').
    rng = np.random.default_rng(0)
    for golden in (0.909368, 0.872385, 0.868683):
        labels = rng.integers(0, 2, 500)
        probs = np.clip(rng.random(500) * 0.6 + labels * 0.3, 0, 1)
        np.testing.assert_allclose(auc_pr(labels, probs, rng.random(500)), golden, atol=2e-5)


# ------------------------------------------------------------------- task


def task_dict(num_classes=2, attention_impl="pallas", **data):
    return {
        "model": {"encoder": {"type": "mmt", "mmt": {**ENCODER, "attention_impl": attention_impl}},
                  "cls_heads": [{"inner_dim": 32, "num_classes": num_classes, "name": "itm"}],
                  "num_classes": num_classes},
        "train_data": {"image_size": 32, "patch_size": 16, "max_seq_len": S, **data},
    }


OPT = {"polynomial": {"initial_learning_rate": 1e-3, "decay_steps": 10},
       "warmup": {"warmup_steps": 1}}


def make_tasks(num_classes=2):
    """The JAX task (dense attention), the port's on the CPU with the JAX
    parameters, and those parameters (numpy tree)."""
    jax_task = JaxTask(jax_override(JaxTaskConfig(), task_dict(num_classes, "xla")),
                       jax_override(JaxTrainerConfig(), {"optimizer_config": OPT}))
    task = ClassificationTask(override(ClassificationTaskConfig(), task_dict(num_classes)),
                              override(TrainerConfig(), {"optimizer_config": OPT}),
                              device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jax_task.init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in make_batch().items()}))
    task.model.load_state_dict(params_from_flax(params, task.model))
    return jax_task, task, params


def make_batch(seed=0, batch=6):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, S + 1, batch).astype(np.int32)
    labels = (np.arange(batch) % 3 == 0).astype(np.int32)
    return {
        "word_ids": rng.integers(0, len(VOCAB), (batch, S)).astype(np.int32),
        "segment_ids": np.where(np.arange(S)[None] < 6, 1, 2).repeat(batch, 0).astype(np.int32),
        "patch_embeddings": rng.normal(size=(batch, 4, 768)).astype(np.float32),
        "lengths": lengths,
        "label_ids": labels,
        "label_weights": (rng.random(batch) < 0.8).astype(np.float32),
        "pos_weights": np.where(labels > 0, 3.0, 1.0).astype(np.float32),
    }


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("num_classes", [1, 2])
def test_compute_loss_matches(num_classes):
    jax_task, task, params = make_tasks(num_classes)
    for seed in range(2):
        batch = make_batch(seed)
        want_loss, (_, want) = jax_task.compute_loss(params, _jnp(batch), None, True)
        loss, (_, got) = task.compute_loss(batch_to_device(batch, "cpu"), None, True)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-5)
        assert got.keys() == want.keys() == {"cls_loss", "cls_accuracy"}
        for name, (total, count) in want.items():
            np.testing.assert_allclose(got[name][0].item(), float(total), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got[name][1].item(), float(count), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_classes", [1, 2, 3])
def test_eval_step_probabilities_match(num_classes):
    jax_task, task, params = make_tasks(num_classes)
    batch = make_batch(5)
    want_metrics, want_probs = jax_task.make_eval_step()(params, _jnp(batch))
    metrics, probs = task.make_eval_step()(batch_to_device(batch, "cpu"))
    assert not task.model.training
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), rtol=1e-5, atol=1e-5)
    for name, (total, count) in want_metrics.items():
        np.testing.assert_allclose(metrics[name][0].item() / metrics[name][1].item(),
                                   float(total) / float(count), rtol=1e-5, atol=1e-5)


def test_three_train_steps_match_jax_params():
    jax_task, task, params = make_tasks(2)
    jstate = JaxTrainState.create(params, jax_optimizer.create_optimizer(
        jax_task.trainer.optimizer_config, 3))
    jstep = jax_task.make_train_step()
    state = TrainState.create(task.model, create_optimizer(task.trainer.optimizer_config, 3,
                                                           task.model))
    step = task.make_train_step()
    for i in range(3):
        batch = make_batch(10 + i)
        jstate, jmetrics = jstep(jstate, _jnp(batch), jax.random.PRNGKey(i))
        state, metrics = step(state, batch_to_device(batch, "cpu"))
        for name, (total, count) in jmetrics.items():
            np.testing.assert_allclose(metrics[name][0].item() / metrics[name][1].item(),
                                       float(total) / float(count), rtol=1e-5, atol=1e-5)
    assert state.step == 3
    want = {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params), task.model).items()}
    start = {k: v.numpy() for k, v in params_from_flax(params, task.model).items()}
    moved = 0
    for name, p in task.model.named_parameters():
        got = p.detach().numpy()
        moved += not np.array_equal(got, start[name])
        assert np.linalg.norm(got - want[name]) <= 1e-5 * max(np.linalg.norm(want[name]), 1e-30) \
            + 1e-7, name
    assert moved > 0.9 * len(want)


# -------------------------------------------------------------------- CLI


def cli_yaml(vocab, train, val, attention_impl, steps=4, hidden_dropout=0.0,
             attention_dropout=0.0, init_checkpoint=""):
    data = data_dict(vocab, train, use_rand_aug=True, is_training=True)
    return {
        "task": {
            "init_checkpoint": init_checkpoint,
            "model": {
                "encoder": {"type": "mmt", "mmt": {
                    **ENCODER, "attention_impl": attention_impl,
                    "hidden_dropout_prob": hidden_dropout,
                    "attention_probs_dropout_prob": attention_dropout}},
                "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}],
                "num_classes": 2},
            "train_data": data,
            "validation_data": {**data, "input_path": val, "is_training": False,
                                "drop_remainder": False, "use_rand_aug": False}},
        "trainer": {"train_steps": steps, "steps_per_loop": 1, "summary_interval": 1,
                    "checkpoint_interval": 2, "validation_interval": 2, "validation_steps": -1,
                    "max_to_keep": 32, "optimizer_config": OPT,
                    "best_checkpoint_export_subdir": "best_ckpt",
                    "best_checkpoint_eval_metric": "cls_accuracy",
                    "best_checkpoint_metric_comp": "higher"},
        # JAX: one device, where its warm start puts the parameters.
        "runtime": {"num_data_parallel": 1}}


def _read_jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_train_and_eval_matches_jax(records, tmp_path, capsys):
    """The slice as a whole: both CLIs from the same parameters on the same
    records, 4 steps with dropout 0, validation at steps 2 and 4."""
    from mmt_tpu.cli.train import main as jax_main
    from mmt_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from mmt_tpu_torch.cli.train import main
    from mmt_tpu_torch.train.checkpoint import CheckpointManager

    _, task, params = make_tasks(2)
    JaxCheckpointManager(str(tmp_path / "jax_init")).save(0, params)
    CheckpointManager(str(tmp_path / "torch_init")).save(0, task.model)
    for name, impl in (("jax", "xla"), ("torch", "pallas")):
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(cli_yaml(
            records["vocab"], records["train"], records["val"], impl,
            init_checkpoint=str(tmp_path / f"{name}_init"))))
    jax_main(["--experiment=mmt/classification", "--mode=train_and_eval",
              f"--model_dir={tmp_path / 'jax_model'}",
              f"--config_file={tmp_path / 'jax.yaml'}"])
    state = main(["--experiment=mmt/classification", "--mode=train_and_eval",
                  f"--model_dir={tmp_path / 'torch_model'}",
                  f"--config_file={tmp_path / 'torch.yaml'}", "--device=cpu"])
    assert state.step == 4
    jax_dir, torch_dir = tmp_path / "jax_model", tmp_path / "torch_model"
    for name in ("params.yaml", "train_summaries.jsonl", "validation_summaries.jsonl",
                 "2", "4", "data_stream", "best_ckpt/best_info.json"):
        assert (jax_dir / name).exists() and (torch_dir / name).exists(), name
    assert yaml.safe_load((torch_dir / "params.yaml").read_text())["trainer"]["train_steps"] == 4
    want, got = (_read_jsonl(d / "validation_summaries.jsonl") for d in (jax_dir, torch_dir))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        for key in ("cls_accuracy", "cls_loss", "auc", "total_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4, err_msg=key)
    assert json.loads((torch_dir / "best_ckpt" / "best_info.json").read_text())["step"] == \
        json.loads((jax_dir / "best_ckpt" / "best_info.json").read_text())["step"]
    train = _read_jsonl(torch_dir / "train_summaries.jsonl")
    jax_train = _read_jsonl(jax_dir / "train_summaries.jsonl")
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    for g, w in zip(train, jax_train):
        np.testing.assert_allclose(g["cls_loss"], w["cls_loss"], rtol=0, atol=1e-4)

    # --mode=eval: the latest checkpoint of model_dir, printed.
    capsys.readouterr()
    metrics = main(["--experiment=mmt/classification", "--mode=eval",
                    f"--model_dir={torch_dir}", f"--config_file={tmp_path / 'torch.yaml'}",
                    "--device=cpu"])
    assert str(metrics) in capsys.readouterr().out
    for key in ("cls_accuracy", "cls_loss", "auc"):
        assert metrics[key] == got[-1][key], key
    # The best checkpoint is a checkpoint directory that cli.predict reads.
    best = CheckpointManager(str(torch_dir / "best_ckpt" / "best_ckpt"))
    assert best.steps() == [json.loads(
        (torch_dir / "best_ckpt" / "best_info.json").read_text())["step"]]
    assert set(best.restore()) == set(task.model.state_dict())


def test_cli_refuses_what_is_not_ported(records, tmp_path):
    from mmt_tpu_torch.cli.train import main

    config = tmp_path / "itm.yaml"
    config.write_text(yaml.safe_dump(cli_yaml(records["vocab"], records["train"],
                                              records["val"], "pallas")))
    base = ["--experiment=mmt/classification", f"--model_dir={tmp_path / 'm'}",
            f"--config_file={config}", "--device=cpu"]
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        main(base + ["--params_override=trainer.grad_accum_dtype=float16"])
    with pytest.raises(NotImplementedError, match="pipeline"):
        main(base + ["--params_override=runtime.num_pipeline_stages=2"])
    with pytest.raises(NotImplementedError, match="ZeRO"):
        main(base + ["--params_override=runtime.zero_sharded_optimizer=true"])
    tf_ckpt = tmp_path / "tf"
    tf_ckpt.mkdir()
    (tf_ckpt / "checkpoint").write_text('model_checkpoint_path: "ckpt-1"\n')
    with pytest.raises(NotImplementedError, match="TF checkpoint"):
        main(base + ["--lenient_warm_start", f"--params_override=task.init_checkpoint={tf_ckpt}"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(base + [f"--params_override=task.init_checkpoint={tmp_path / 'missing'}"])
    with pytest.raises(ValueError, match="input_path is empty"):
        main(base + ['--params_override={"task": {"train_data": {"input_path": ""}}}'])
    with pytest.raises(NotImplementedError, match="retrieval"):
        main(["--experiment=mmt/retrieval", f"--model_dir={tmp_path / 'r'}", "--device=cpu"])
    assert not os.path.exists(tmp_path / "m" / "2")
