"""Warm starts through the port's train CLI, and the Orbax bridge.

* The shipped ``*_from_vit`` pretraining yamls through the port's CLI from a
  ViT checkpoint TF wrote (``tests/test_warm_start.py``'s
  ``TestFromVitYamlTrainSmoke``, at its tiny geometry): the CLI's warm start
  is the converter's (``train/vit_checkpoint.py``), every loss finite.
* Flickr30k finetuning from a TF MMT checkpoint (the port's pretraining
  state in the reference's layout, ``export_tf_layout``, written by TF):
  strict, every tensor restored; with ``--lenient_warm_start`` and a partial
  checkpoint, the rest kept fresh; strict with that partial checkpoint, the
  JAX package's ValueError.
* ``scripts/orbax_to_torch.py`` on a checkpoint the JAX package's
  ``CheckpointManager`` wrote: the port's tensors equal ``params_from_flax``
  of the restored tree, and the predict step's scores within 1e-5 of JAX's
  (``tests/test_torch_finetune.py``'s tolerance for the eval step).
* ``chip_smoke.from_vit_experiment`` is mlm_itm_2d_from_vit.yaml with only
  its schedule cut.
"""

import importlib.util
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp  # noqa: E402

import tests.test_torch_finetune as ft  # noqa: E402
import tests.test_warm_start as jax_warm  # noqa: E402
from mmt_tpu_torch.configs import get_experiment_config, override  # noqa: E402
from mmt_tpu_torch.convert import flax_paths, params_from_flax  # noqa: E402
from mmt_tpu_torch.train import tf_checkpoint, vit_checkpoint  # noqa: E402
from mmt_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from tests.test_data_pipeline import make_vocab, write_records  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-5


def _write_tf(path: str, variables: dict) -> str:
    """``variables`` ({object path: array}) as ``tf.train.Checkpoint(model=
    root)`` writes a module tree with those attribute paths."""
    root = tf.Module()
    for name, value in variables.items():
        node = root
        *parents, leaf = name.split("/")
        for part in parents:
            if not hasattr(node, part):
                setattr(node, part, tf.Module())
            node = getattr(node, part)
        setattr(node, leaf, tf.Variable(np.asarray(value)))
    return tf.train.Checkpoint(model=root).write(path)


def _restored(caplog):
    return [int(r.getMessage().split("count_restored=")[1].split()[0])
            for r in caplog.records if "count_restored=" in r.getMessage()]


@pytest.fixture
def captured_warm_start(monkeypatch):
    """Wraps the CLI's ``warm_start``: records the task model's state after
    it (copied to the CPU) and the count it returned."""
    from mmt_tpu_torch.cli import train as cli_train

    seen = []
    real = cli_train.warm_start

    def wrapper(task, path, strict=True):
        n = real(task, path, strict=strict)
        seen.append((n, {k: v.detach().clone() for k, v in task.model.state_dict().items()},
                     task))
        return n

    monkeypatch.setattr(cli_train, "warm_start", wrapper)
    return seen


@pytest.mark.parametrize("yaml_rel", [
    "pretrain/wit/mlm_itm_from_vit.yaml",
    "pretrain/wit/mlm_itm_2d_from_vit.yaml",
])
def test_from_vit_yaml_trains_through_the_cli(tmp_path, yaml_rel, caplog, captured_warm_start):
    from mmt_tpu_torch.cli.train import main

    vit_path, _ = jax_warm.TestVitWarmStart()._vit_ckpt(tmp_path, src_grid=4)
    rng = np.random.default_rng(3)
    vocab = make_vocab(tmp_path)
    records = write_records(str(tmp_path / "t.tfrecord"), 20, rng)
    is_2d = "2d" in yaml_rel
    params_override = yaml.safe_dump({
        "task": {
            "init_checkpoint": vit_path,
            "model": {"encoder": {"mmt": {
                "vocab_size": 40, "hidden_size": jax_warm.HIDDEN,
                "num_hidden_layers": jax_warm.LAYERS, "num_attention_heads": jax_warm.HEADS,
                "intermediate_size": jax_warm.INTER, "relative_pos_max_distance": 3,
                "relative_vocab_size": 12 if is_2d else 10, "compute_dtype": "float32",
                "attention_impl": "xla",
                "max_absolute_position_embeddings": 38,  # 2 + 6x6 grid, >= S
                "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}},
                "cls_heads": [{"inner_dim": jax_warm.HIDDEN, "num_classes": 2, "name": "itm"}]},
            "train_data": {
                "vocab_filename": vocab, "input_path": records, "image_size": 32,
                "patch_size": 16, "max_seq_len": 32, "min_shift": 2, "global_batch_size": 16,
                "shuffle_buffer_size": 16, "mlm_max_selections_per_seq": 8,
                "mpp_max_selections_per_seq": 4, "min_text_wordpieces": 3,
                "use_rand_aug": False}},
        "trainer": {"train_steps": 2, "steps_per_loop": 1, "summary_interval": 1,
                    "checkpoint_interval": 2, "validation_interval": 100,
                    "micro_batch_size": 4},
    })
    model_dir = tmp_path / f"model_{is_2d}"
    caplog.set_level(logging.INFO)
    main(["--experiment=mmt/pretraining", "--mode=train", f"--model_dir={model_dir}",
          f"--config_file={REPO / 'configs' / 'exp_yamls' / yaml_rel}",
          f"--params_override={params_override}", "--device=cpu"])
    rows = [json.loads(line) for line in (model_dir / "train_summaries.jsonl").open()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and r["total_loss"] > 0 for r in rows)
    # The CLI's warm start is the converter's on the same fresh model: the
    # image-relevant tensors restored (the 4x4 grid interpolated to 6x6).
    (count, state, task), = captured_warm_start
    paths = flax_paths(task.model)
    image = {n for n, p in paths.items() if not vit_checkpoint._is_text_only(tuple(p.split("/")))}
    assert count == len(image) and _restored(caplog) == [count]
    want = vit_checkpoint.convert_vit_checkpoint(tf_checkpoint.load_tf_checkpoint(vit_path),
                                                 task.model)
    for name in image:
        assert torch.equal(state[name], want[name]), name
    assert state["encoder.absolute_position_embeddings"].shape == (38, jax_warm.HIDDEN)


def _finetune_setup(tmp_path, drop=()):
    """Records, a pretraining model of the finetune test's geometry and its
    state in the reference's TF layout written by TF (without the paths
    that contain any of ``drop``); returns (records, tf prefix, the
    exported names, the pretraining state)."""
    from mmt_tpu_torch.configs import ClsHeadConfig, EncoderConfig, MmtEncoderConfig
    from mmt_tpu_torch.configs import PretrainModelConfig
    from mmt_tpu_torch.models import MmtPretrainingModel

    records = {"vocab": ft.write_vocab(tmp_path),
               "train": ft.write_paired_records(tmp_path / "train.tfrecord", 16, seed=0),
               "val": ft.write_paired_records(tmp_path / "val.tfrecord", 8, seed=1)}
    cfg = PretrainModelConfig(encoder=EncoderConfig(mmt=MmtEncoderConfig(**ft.ENCODER)),
                              cls_heads=[ClsHeadConfig(inner_dim=32, num_classes=2, name="itm")])
    model = MmtPretrainingModel(cfg, num_patch_per_row=2, patch_dim=768, device="cpu", seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # no tensor left at its (often zero) initial value
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    state = model.state_dict()
    exported = {k: v for k, v in tf_checkpoint.export_tf_layout(state, model).items()
                if not any(d in k for d in drop)}
    return records, _write_tf(str(tmp_path / "mmt_ckpt"), exported), exported, state


def _finetune_cli(tmp_path, records, init_checkpoint, *flags):
    from mmt_tpu_torch.cli.train import main

    config = tmp_path / "itm.yaml"
    config.write_text(yaml.safe_dump(ft.cli_yaml(records["vocab"], records["train"],
                                                 records["val"], "xla", steps=2,
                                                 init_checkpoint=init_checkpoint)))
    model_dir = tmp_path / "ft"
    main(["--experiment=mmt/classification", "--mode=train", f"--model_dir={model_dir}",
          f"--config_file={config}", "--device=cpu", *flags])
    return model_dir


def test_finetune_from_a_tf_mmt_checkpoint(tmp_path, caplog, captured_warm_start):
    """Strict: every tensor of the classification model comes from the
    checkpoint (the encoder and the itm head), bit for bit."""
    records, prefix, _, pretrain = _finetune_setup(tmp_path)
    caplog.set_level(logging.INFO)
    model_dir = _finetune_cli(tmp_path, records, prefix)
    (count, state, task), = captured_warm_start
    assert count == len(state) and _restored(caplog) == [count]
    for name, value in state.items():
        assert torch.equal(value, pretrain[name]), name
    rows = [json.loads(line) for line in (model_dir / "train_summaries.jsonl").open()]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["cls_loss"]) for r in rows)


def test_finetune_from_a_partial_tf_checkpoint_lenient_and_strict(tmp_path, caplog,
                                                                  captured_warm_start):
    """Without layer 1's FFN: strict raises JAX's ValueError; lenient keeps
    the fresh initialisation of what stays unmatched.  The JAX package's
    suffix pass fills ``ffn_output.bias`` of layer 1 with the MLM head's
    ``transform_dense/bias`` (the same size, one shared trailing token), and
    the port does the same."""
    records, prefix, exported, pretrain = _finetune_setup(tmp_path, ("feed_forward_layers/1/",))
    with pytest.raises(ValueError, match="3/45 target params unmatched"):
        _finetune_cli(tmp_path, records, prefix)
    assert captured_warm_start == []
    caplog.set_level(logging.INFO)
    _finetune_cli(tmp_path, records, prefix, "--lenient_warm_start")
    (count, state, task), = captured_warm_start
    fresh = {"encoder.transformer.layers.1.intermediate.weight",
             "encoder.transformer.layers.1.intermediate.bias",
             "encoder.transformer.layers.1.ffn_output.weight"}
    assert count == len(state) - len(fresh) and _restored(caplog) == [count]
    pretrain = {**pretrain, "encoder.transformer.layers.1.ffn_output.bias":
                pretrain["masked_lm.transform_dense.bias"]}
    for name, value in state.items():
        assert torch.equal(value, pretrain[name]) != (name in fresh), name


def _orbax_to_torch():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "scripts" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_bridge_scores_as_jax(tmp_path):
    from mmt_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from mmt_tpu_torch.cli.train import build_experiment_config, parse_args
    from mmt_tpu_torch.train.tasks import ClassificationTask

    jax_task, _, params = ft.make_tasks(2)
    JaxCheckpointManager(str(tmp_path / "jax")).save(3, params)
    vocab = ft.write_vocab(tmp_path)
    config = tmp_path / "itm.yaml"
    config.write_text(yaml.safe_dump(ft.cli_yaml(vocab, "unused", "unused", "pallas")))
    written = _orbax_to_torch().main([f"--orbax_dir={tmp_path / 'jax'}",
                                      "--experiment=mmt/classification",
                                      f"--config_file={config}", f"--out={tmp_path / 'torch'}"])
    assert written == str(tmp_path / "torch" / "3" / "model.pt")
    cfg = build_experiment_config(parse_args(["--experiment=mmt/classification",
                                              "--model_dir=unused", f"--config_file={config}"]))
    task = ClassificationTask(cfg.task, cfg.trainer, device="cpu")
    state = CheckpointManager(str(tmp_path / "torch")).restore()
    want = params_from_flax(params, task.model)
    assert set(state) == set(want) and all(torch.equal(state[k], want[k]) for k in want)
    task.model.load_state_dict(state)
    batch = ft.make_batch(seed=4)
    got = task.make_inference_step()(batch).numpy()
    ref = np.asarray(jax_task.make_inference_step()(params, {k: jnp.asarray(v)
                                                             for k, v in batch.items()}))
    np.testing.assert_allclose(got, ref, atol=SCORE_ATOL, rtol=0)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _orbax_to_torch().main([f"--orbax_dir={tmp_path / 'empty'}",
                                f"--config_file={config}", f"--out={tmp_path / 'x'}"])


def test_chip_smoke_from_vit_experiment_is_the_yaml(tmp_path):
    import chip_smoke
    from mmt_tpu_torch.configs.base import from_yaml_file

    path = REPO / "configs/exp_yamls/pretrain/wit/mlm_itm_2d_from_vit.yaml"
    want = from_yaml_file(get_experiment_config("mmt/pretraining"), str(path)).as_dict()
    got = override(get_experiment_config("mmt/pretraining"),
                   chip_smoke.from_vit_experiment(tmp_path, str(tmp_path / "vit"))).as_dict()
    assert got["task"]["init_checkpoint"] == str(tmp_path / "vit")
    cuts = {"train_data": ("input_path", "vocab_filename", "global_batch_size",
                           "shuffle_buffer_size"),
            "validation_data": ("input_path", "vocab_filename")}
    for section in (want, got):
        section["task"]["init_checkpoint"] = None
        for split, keys in cuts.items():
            section["task"][split].update({k: None for k in keys})
        for key in ("train_steps", "steps_per_loop", "summary_interval", "validation_interval",
                    "validation_steps"):
            section["trainer"][key] = None
    assert got == want


def test_chip_smoke_vit_check_agrees_with_the_converter(tmp_path):
    """chip_smoke's ViT (``seeded_vit``, here at hidden 32, 2 layers) through
    its own bundle writer and the converter: every image-relevant tensor is
    ``vit_expected`` of the written arrays, bit for bit."""
    import chip_smoke
    from mmt_tpu_torch.configs import ClsHeadConfig, EncoderConfig, MmtEncoderConfig
    from mmt_tpu_torch.configs import PretrainModelConfig
    from mmt_tpu_torch.models import MmtPretrainingModel

    enc = MmtEncoderConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64,
                           relative_pos_max_distance=3, relative_vocab_size=12,
                           max_absolute_position_embeddings=chip_smoke.VIT_POSITIONS)
    model = MmtPretrainingModel(
        PretrainModelConfig(encoder=EncoderConfig(mmt=enc),
                            cls_heads=[ClsHeadConfig(inner_dim=32, num_classes=2, name="itm")]),
        num_patch_per_row=24, patch_dim=3 * chip_smoke.VIT_PATCH ** 2, device="cpu")
    vit = chip_smoke.seeded_vit(3, layers=2, hidden=32, inter=64)
    prefix = chip_smoke.write_tf_checkpoint(tmp_path, vit)
    assigned = set()
    state = vit_checkpoint.convert_vit_checkpoint(tf_checkpoint.load_tf_checkpoint(prefix), model,
                                                  assigned=assigned)
    paths = flax_paths(model)
    image = {n for n, p in paths.items() if not vit_checkpoint._is_text_only(tuple(p.split("/")))}
    assert assigned == image and len(image) == 5 + 2 * 16
    for name in image:
        np.testing.assert_array_equal(state[name].numpy(),
                                      chip_smoke.vit_expected(vit, paths[name]), err_msg=name)
