"""The train and predict CLIs in two ``gloo`` processes on the CPU.

Counterparts of ``tests/test_multihost.py``: each test runs
``mmt_tpu_torch.cli.{train,predict}.main`` on two ranks
(``parallel.launch.run_local``; the ranks' code is
``tests/torch_gloo_workers.py``) and checks what a user sees:

* training (dummy pretraining input, ZeRO-1 on): rank 0 alone writes
  ``params.yaml``, one summary line per step and the checkpoint, and each
  step's losses equal a one-process run's within 1e-6 relative (the ranks'
  dummy rows are the one-process batch's);
* pipelined pretraining on four ranks (a 2 x 2 data x pipe mesh): one
  summary row per step, the checkpoint, and the losses of one unpipelined
  process;
* a preemption signalled on rank 1 only checkpoints both ranks at the same
  step, and both exit through the CLI's preemption path;
* ``train_and_eval`` with ``validation_steps`` 2: the AUC of the gathered
  (label, probability, weight) triples equals the AUC that one process
  computes from the same checkpoint on the ranks' validation batches;
* predict with a batch of 5 (rounded up to 6 for two ranks):
  ``results.csv`` and ``recall.json`` byte-equal to a one-process run's.
"""

import json

import numpy as np
import pytest
import torch

from mmt_tpu_torch.parallel.launch import run_local
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from tests import torch_gloo_workers
from tests.test_torch_finetune import cli_yaml, write_paired_records, write_vocab

PRETRAIN = {
    "task": {
        "model": {
            "encoder": {"mmt": {
                "vocab_size": 40, "hidden_size": 32, "num_hidden_layers": 1,
                "num_attention_heads": 2, "intermediate_size": 64,
                "relative_pos_max_distance": 3, "relative_vocab_size": 12,
                "relative_att_num_core_layers": 1, "compute_dtype": "float32",
                "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}},
            "cls_heads": [{"inner_dim": 32, "num_classes": 2, "name": "itm"}]},
        "train_data": {"input_path": "dummy", "image_size": 32, "patch_size": 16,
                       "max_seq_len": 32, "global_batch_size": 8,
                       "mlm_max_selections_per_seq": 4, "mpp_max_selections_per_seq": 4}},
    "trainer": {"train_steps": 3, "steps_per_loop": 1, "summary_interval": 1,
                "checkpoint_interval": 3, "validation_interval": 100},
}


def _read_jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _train_argv(config, model_dir, experiment="mmt/pretraining", mode="train"):
    return [f"--experiment={experiment}", f"--mode={mode}", f"--model_dir={model_dir}",
            f"--config_file={config}", "--device=cpu"]


def test_two_process_training(tmp_path):
    from mmt_tpu_torch.cli.train import main

    cfg = {**PRETRAIN, "runtime": {"zero_sharded_optimizer": True}}
    config = tmp_path / "pretrain.json"
    config.write_text(json.dumps(cfg))
    run_local(torch_gloo_workers.run_cli, 2, "mmt_tpu_torch.cli.train",
              _train_argv(config, tmp_path / "mp"))
    main(_train_argv(config, tmp_path / "sp"))
    mp, sp = tmp_path / "mp", tmp_path / "sp"
    assert json.loads((mp / "params.yaml").read_text())["runtime"]["zero_sharded_optimizer"]
    rows, want = _read_jsonl(mp / "train_summaries.jsonl"), _read_jsonl(sp / "train_summaries.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3]
    for got, ref in zip(rows, want):
        for key in ("total_loss", "mlm_loss", "mpp_loss", "itm_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=0, err_msg=key)
    assert (mp / "3" / "optimizer.pt").exists()
    state = torch.load(mp / "3" / "optimizer.pt", weights_only=True)
    ref = torch.load(sp / "3" / "optimizer.pt", weights_only=True)
    assert all(state["mu"][n].shape == ref["mu"][n].shape for n in ref["mu"])  # global moments


def test_four_process_pipelined_pretraining(tmp_path):
    """``runtime.num_pipeline_stages: 2`` on four ranks: a 2 x 2 ('data',
    'pipe') mesh, 2 layers, 2 micro-batches, ZeRO-1 (the counterpart of
    ``tests/test_train_cli_pretrain.py:86``).  Rank 0 writes one summary
    row per step with every loss and accuracy finite, and the checkpoint at
    the last step; each step's losses equal one unpipelined process's on
    the same batches within 1e-5 (both are weighted means over the global
    batch at dropout 0)."""
    from mmt_tpu_torch.cli.train import main

    cfg = json.loads(json.dumps(PRETRAIN))
    cfg["task"]["model"]["encoder"]["mmt"]["num_hidden_layers"] = 2
    config = tmp_path / "pretrain.json"
    config.write_text(json.dumps(cfg))
    piped = tmp_path / "piped.json"
    piped.write_text(json.dumps({**cfg, "runtime": {"num_pipeline_stages": 2,
                                                    "num_pipeline_microbatches": 2,
                                                    "zero_sharded_optimizer": True}}))
    run_local(torch_gloo_workers.run_cli, 4, "mmt_tpu_torch.cli.train",
              _train_argv(piped, tmp_path / "pp"))
    main(_train_argv(config, tmp_path / "sp"))
    pp_dir, sp = tmp_path / "pp", tmp_path / "sp"
    assert json.loads((pp_dir / "params.yaml").read_text())["runtime"]["num_pipeline_stages"] == 2
    rows, want = _read_jsonl(pp_dir / "train_summaries.jsonl"), _read_jsonl(
        sp / "train_summaries.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3]
    for key in ("total_loss", "mlm_loss", "mpp_loss", "itm_loss", "mlm_accuracy",
                "mpp_accuracy", "itm_accuracy"):
        assert all(np.isfinite(r[key]) for r in rows), key
    for got, ref in zip(rows, want):
        for key in ("total_loss", "mlm_loss", "mpp_loss", "itm_loss"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=0, err_msg=key)
    assert CheckpointManager(str(pp_dir)).latest_step() == 3


def test_two_process_preemption_collective_save(tmp_path):
    cfg = {**PRETRAIN, "trainer": {**PRETRAIN["trainer"], "train_steps": 5,
                                   "checkpoint_interval": 5}}
    config = tmp_path / "pretrain.json"
    config.write_text(json.dumps(cfg))
    model_dir = tmp_path / "model"
    outs = run_local(torch_gloo_workers.run_cli, 2, "mmt_tpu_torch.cli.train",
                     _train_argv(config, model_dir), 1)
    for out in outs:
        assert "exiting after preemption checkpoint at step 2" in out["log"], out["log"]
        assert out["result"] is None
    assert sorted(p.name for p in model_dir.iterdir() if p.name.isdigit()) == ["2"]
    assert [r["step"] for r in _read_jsonl(model_dir / "train_summaries.jsonl")] == [1, 2]


def test_two_process_train_and_eval_gathers_step_major(tmp_path):
    from mmt_tpu_torch.configs import get_experiment_config
    from mmt_tpu_torch.configs.base import from_yaml_file
    from mmt_tpu_torch.data.loaders import MmtClassificationLoader
    from mmt_tpu_torch.eval.metrics_host import auc_pr
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask, batch_to_device

    vocab = write_vocab(tmp_path)
    cfg = cli_yaml(vocab, write_paired_records(tmp_path / "train.tfrecord", 40, seed=0),
                   write_paired_records(tmp_path / "val.tfrecord", 48, seed=1), "pallas",
                   steps=2)
    # 8 records a rank's batch: the matching needs more than ratio + 1 + min_shift.
    cfg["task"]["train_data"]["global_batch_size"] = 64
    cfg["task"]["validation_data"]["global_batch_size"] = 64
    cfg["trainer"].update(validation_steps=2, checkpoint_interval=2)
    cfg["runtime"] = {"num_data_parallel": 0}
    config = tmp_path / "itm.json"
    config.write_text(json.dumps(cfg))
    model_dir = tmp_path / "model"
    run_local(torch_gloo_workers.run_cli, 2, "mmt_tpu_torch.cli.train",
              _train_argv(config, model_dir, "mmt/classification", "train_and_eval"))
    rows = _read_jsonl(model_dir / "validation_summaries.jsonl")
    assert [r["step"] for r in rows] == [2]

    # One process: the step-2 checkpoint on each rank's two batches of 32.
    exp = from_yaml_file(get_experiment_config("mmt/classification"), str(config))
    task = ClassificationTask(exp.task, exp.trainer, device="cpu")
    task.model.load_state_dict(CheckpointManager(str(model_dir)).restore(2))
    step = task.make_eval_step()
    loader = MmtClassificationLoader(exp.task.validation_data)
    triples = {"label_ids": [], "probs": [], "label_weights": []}
    for rank in range(2):
        for i, batch in zip(range(2), loader.load(rank, 2, batch_size=32)):
            _, probs = step(batch_to_device(batch, "cpu"))
            triples["probs"].append(probs.numpy())
            triples["label_ids"].append(batch["label_ids"])
            triples["label_weights"].append(batch["label_weights"])
    want = auc_pr(*(np.concatenate(triples[k]) for k in ("label_ids", "probs", "label_weights")))
    assert rows[0]["auc"] == pytest.approx(want, rel=0, abs=1e-12)
    assert 0.0 < want < 1.0


def test_two_process_predict_writes_what_one_process_writes(tmp_path):
    from mmt_tpu_torch.cli import predict as cli_predict
    from mmt_tpu_torch.configs import get_experiment_config
    from mmt_tpu_torch.configs.base import from_yaml_file
    from mmt_tpu_torch.train.checkpoint import CheckpointManager
    from mmt_tpu_torch.train.tasks import ClassificationTask
    from mmt_tpu_torch.data.tfrecord import TFRecordWriter, build_example
    from tests.test_torch_predict_cli import (
        NUM_IMAGES,
        NUM_TEXTS,
        VOCAB,
        WORDS,
        _experiment_yaml,
        _png,
    )

    rng = np.random.default_rng(0)
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    with TFRecordWriter(str(tmp_path / "img.tfrecord")) as w:
        for i in range(NUM_IMAGES):
            w.write(build_example({"image_data": [_png(rng)], "image_key": [f"img{i}".encode()],
                                   "image_index": [i]}))
    with TFRecordWriter(str(tmp_path / "txt.tfrecord")) as w:
        for t in range(NUM_TEXTS):
            caption = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 20))))
            w.write(build_example({"caption": [caption.encode()], "text_index": [t],
                                   "gt_image_index": [t // 2]}))
    (tmp_path / "meta.json").write_text(json.dumps({
        "max_seq_length": 32, "test_image_input_path": str(tmp_path / "img.tfrecord"),
        "test_text_input_path": str(tmp_path / "txt.tfrecord"),
        "test_num_image_examples": NUM_IMAGES, "test_num_text_examples": NUM_TEXTS}))
    config = tmp_path / "exp.json"
    config.write_text(json.dumps(_experiment_yaml(str(tmp_path / "vocab.txt"), "pallas")))
    exp = from_yaml_file(get_experiment_config("mmt/classification"), str(config))
    CheckpointManager(str(tmp_path / "ckpt")).save(
        0, ClassificationTask(exp.task, exp.trainer, device="cpu", seed=3).model)

    def argv(out):
        return [f"--config_file={config}", f"--input_meta_data_path={tmp_path / 'meta.json'}",
                "--predict_split=test", f"--init_checkpoint={tmp_path / 'ckpt'}",
                f"--test_output_dir={out}", "--predict_global_batch_size=5", "--device=cpu"]

    cli_predict.main(argv(tmp_path / "one"))
    run_local(torch_gloo_workers.run_cli, 2, "mmt_tpu_torch.cli.predict", argv(tmp_path / "two"))
    for name in ("results.csv", "recall.json"):
        assert (tmp_path / "two" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
    assert len((tmp_path / "one" / "results.csv").read_text().splitlines()) == \
        NUM_IMAGES * NUM_TEXTS + 1
