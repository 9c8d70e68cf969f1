"""The port's serving export (``mmt_tpu_torch/eval/export.py``) against its
inference step and against the JAX package's (``mmt_tpu/eval/export.py``),
case for case with ``tests/test_export.py``.

The JAX side is ``tests/test_train.py``'s tiny classification task and
batches (hidden 32, 2 layers, S=12, 4 patches of 12 features); the port's
task has the same geometry (image 4 / patch 2, so P=2 and patch_dim 12)
and the Flax parameters through ``convert.params_from_flax``.  Bounds: an
artifact equals the port's inference step (rtol 1e-6, atol 1e-7, as the
JAX tests hold theirs); port against JAX within 1e-4 (float32 models that
sum in other orders).
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from mmt_tpu.eval import export as jax_export
from mmt_tpu_torch.cli import predict as cli_predict
from mmt_tpu_torch.configs import (
    ClassificationModelConfig,
    ClassificationTaskConfig,
    ClsHeadConfig,
    EncoderConfig,
    MmtClassificationDataConfig,
    MmtEncoderConfig,
    TrainerConfig,
    get_experiment_config,
)
from mmt_tpu_torch.configs.base import from_yaml_file
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.eval import export
from mmt_tpu_torch.train.checkpoint import CheckpointManager
from mmt_tpu_torch.train.tasks import ClassificationTask
from tests.test_torch_predict_cli import BATCH, _torch_args, workdir  # noqa: F401
from tests.test_train import classification_batch, make_classification_task

JAX_BOUND = 1e-4
ENCODER = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64, relative_pos_max_distance=3, relative_vocab_size=12,
               relative_att_num_core_layers=1, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, compute_dtype="float32")


def _torch_task(attention_impl="xla", quantize="none"):
    cfg = ClassificationTaskConfig(
        model=ClassificationModelConfig(
            encoder=EncoderConfig(mmt=MmtEncoderConfig(
                **ENCODER, attention_impl=attention_impl, quantize=quantize)),
            num_classes=2, cls_heads=[ClsHeadConfig(inner_dim=32, num_classes=2, name="itm")]),
        train_data=MmtClassificationDataConfig(image_size=4, patch_size=2, max_seq_len=12))
    return ClassificationTask(cfg, TrainerConfig(train_steps=50), device="cpu")


def _batch(B):
    """``tests/test_train.py``'s classification batch as numpy arrays."""
    return {k: np.array(v) for k, v in classification_batch(B=B).items()}


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def flax_params():
    task = make_classification_task()
    return task, task.init(jax.random.PRNGKey(0), classification_batch(B=4))


@pytest.fixture(scope="module")
def exported(flax_params):
    """The port's xla task with the Flax parameters, its state dict and a
    symbolic-batch artifact exported at batch 4."""
    task = _torch_task()
    task.model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax_params[1]), task.model))
    params = task.model.state_dict()
    return task, params, export.export_scoring(task, params, _batch(4))


class TestExportScoring:
    def test_round_trip_matches_inference_step(self, exported):
        task, params, blob = exported
        assert isinstance(blob, bytes) and len(blob) > 1000
        art = export.load_scoring(blob)
        step = task.make_inference_step()
        for B in (1, 4, 8):  # symbolic batch, size 1 included: one artifact
            batch = _batch(B)
            got = art.call(params, export.scoring_inputs(batch))
            assert got.shape == (B,)
            _close(got, step(batch))

    def test_params_are_arguments_not_constants(self, exported):
        task, params, blob = exported
        art = export.load_scoring(blob)
        step = task.make_inference_step()
        params2 = {k: v + 0.05 for k, v in params.items()}
        batch = _batch(4)
        got = art.call(params2, batch)
        assert not np.allclose(got.numpy(), step(batch).numpy())
        task2 = _torch_task()
        task2.model.load_state_dict(params2)
        _close(got, task2.make_inference_step()(batch))
        # The artifact holds the program, no weight and no example input.
        names = zipfile.ZipFile(io.BytesIO(blob)).namelist()
        assert not [n for n in names if "/weights/" in n and not n.endswith(".json")]
        assert not [n for n in names if "sample_inputs" in n and zipfile.ZipFile(
            io.BytesIO(blob)).getinfo(n).file_size]

    def test_static_batch_export(self, exported):
        """``symbolic_batch=False``: the artifact is fixed to the example
        batch size."""
        task, params, _ = exported
        batch = _batch(4)
        art = export.load_scoring(export.export_scoring(task, params, batch,
                                                        symbolic_batch=False))
        assert art.batch_size == 4
        _close(art.call(params, batch), task.make_inference_step()(batch))
        with pytest.raises(Exception):  # another batch size is refused
            art.call(params, _batch(8))

    def test_platforms_other_than_the_device_raise(self, exported):
        task, params, _ = exported
        export.export_scoring(task, params, _batch(2), platforms=("cpu",))
        with pytest.raises(NotImplementedError, match="traced for the device"):
            export.export_scoring(task, params, _batch(2), platforms=("cpu", "tpu"))


def test_xla_artifact_matches_jax_artifact(flax_params, exported):
    """Symbolic batch, called at 1, 3 and 7: the port's artifact against
    JAX's artifact on the same inputs and parameters."""
    jax_task, params = flax_params
    jax_art = jax_export.load_scoring(jax_export.export_scoring(jax_task, params,
                                                                classification_batch(B=4)))
    _, torch_params, blob = exported
    art = export.load_scoring(blob)
    for B in (1, 3, 7):
        want = np.asarray(jax_art.call(params, jax_export.scoring_inputs(classification_batch(B))))
        got = art.call(torch_params, _batch(B)).numpy()
        assert got.shape == want.shape == (B,)
        assert np.abs(got - want).max() <= JAX_BOUND


def test_pallas_artifact_matches_jax_interpret(flax_params):
    """The fused op's artifact (static batch; its CPU version is the plain
    one) against JAX's inference step with the interpret-mode kernel."""
    _, params = flax_params
    jax_task = make_classification_task(attention_impl="pallas_interpret")
    want = np.asarray(jax_task.make_inference_step()(params, classification_batch(B=4)))
    task = _torch_task("pallas")
    task.model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                task.model))
    state = task.model.state_dict()
    blob = export.export_scoring(task, state, _batch(4), symbolic_batch=False)
    assert b"mmt_tpu_torch.rel_attention_fwd" in b"".join(
        zipfile.ZipFile(io.BytesIO(blob)).read(n) for n in zipfile.ZipFile(
            io.BytesIO(blob)).namelist() if n.endswith("model.json"))
    got = export.load_scoring(blob).call(state, _batch(4)).numpy()
    _close(got, task.make_inference_step()(_batch(4)))
    assert np.abs(got - want).max() <= JAX_BOUND


def test_fresh_process_loads_without_the_model_code(exported, tmp_path):
    task, params, blob = exported
    (tmp_path / "art.bin").write_bytes(blob)
    torch.save(params, tmp_path / "params.pt")
    np.savez(tmp_path / "batch.npz", **_batch(3))
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "from mmt_tpu_torch.eval.export import load_scoring\n"
        f"art = load_scoring(open({str(tmp_path / 'art.bin')!r}, 'rb').read())\n"
        f"params = torch.load({str(tmp_path / 'params.pt')!r})\n"
        f"batch = dict(np.load({str(tmp_path / 'batch.npz')!r}))\n"
        "scores = art.call(params, batch).tolist()\n"
        "assert not [m for m in sys.modules if m.startswith('mmt_tpu_torch.models')]\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'mmt_tpu')]\n"
        "print(json.dumps(scores))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    _close(json.loads(out.stdout), task.make_inference_step()(_batch(3)))


def _cli_checkpoint(workdir, tmp_path):  # noqa: F811
    cfg = from_yaml_file(get_experiment_config("mmt/classification"),
                         str(workdir / "torch.yaml"))
    task = ClassificationTask(cfg.task, cfg.trainer, device="cpu", seed=3)
    ckpt = tmp_path / "ckpt"
    CheckpointManager(str(ckpt)).save(1, task.model)
    return task, ckpt


def test_predict_cli_export_flag(workdir, tmp_path):  # noqa: F811
    """``--export_serving_artifact`` writes a loadable artifact and skips
    scoring (no results.csv); the artifact scores the CLI's first batch as
    the inference step does."""
    task, ckpt = _cli_checkpoint(workdir, tmp_path)
    artifact = tmp_path / "scoring.pt2"
    cli_predict.main(_torch_args(workdir, ckpt, tmp_path / "pred",
                                 f"--export_serving_artifact={artifact}"))
    assert artifact.exists() and not (tmp_path / "pred" / "results.csv").exists()
    art = export.load_scoring(artifact.read_bytes())
    assert art.batch_size == BATCH  # the fused op's config: a static batch, as in JAX
    first = _first_cli_batch(workdir)
    _close(art.call(task.model.state_dict(), first), task.make_inference_step()(first))


def _first_cli_batch(workdir):  # noqa: F811
    from mmt_tpu_torch.data.loaders import MmtRetrievalLoader

    cfg = from_yaml_file(get_experiment_config("mmt/classification"),
                         str(workdir / "torch.yaml"))
    meta = json.loads((workdir / "meta.json").read_text())
    data_cfg = cli_predict.build_retrieval_data_config(cfg.task.train_data, meta, "test", BATCH)
    return next(iter(MmtRetrievalLoader(data_cfg).load()))


def test_predict_cli_export_bundle(workdir, tmp_path):  # noqa: F811
    task, ckpt = _cli_checkpoint(workdir, tmp_path)
    bundle = tmp_path / "bundle.zip"
    cli_predict.main(_torch_args(workdir, ckpt, tmp_path / "pred",
                                 f"--export_serving_artifact={bundle}",
                                 "--export_bucket_sizes= 1, 4,"))
    scorer = export.load_scoring_bundle(bundle.read_bytes())
    assert scorer.batch_sizes == [1, 4]
    first = _first_cli_batch(workdir)
    _close(scorer.call(task.model.state_dict(), first),
           task.make_inference_step()(first).numpy(), atol=1e-6)


@pytest.mark.parametrize("value", ["1,x", "0,4", "-2", " , "])
def test_predict_cli_bad_bucket_sizes_exit_2(workdir, tmp_path, value):  # noqa: F811
    with pytest.raises(SystemExit) as err:
        cli_predict.main(_torch_args(workdir, tmp_path / "ckpt", tmp_path / "pred",
                                     f"--export_serving_artifact={tmp_path / 'b.zip'}",
                                     f"--export_bucket_sizes={value}"))
    assert err.value.code == 2
    assert not (tmp_path / "b.zip").exists()


class TestScoringBundle:
    """Bucketed static-batch bundle."""

    def test_bundle_pads_splits_and_matches_direct(self, exported):
        task, params, _ = exported
        blob = export.export_scoring_bundle(task, params, _batch(4), batch_sizes=(4, 1))
        scorer = export.load_scoring_bundle(blob)
        assert scorer.batch_sizes == [1, 4]
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            assert sorted(zf.namelist()) == ["bucket_1.bin", "bucket_4.bin", "manifest.json"]
            assert json.loads(zf.read("manifest.json")) == {
                "format": "mmt_tpu_torch.scoring_bundle.v1", "batch_sizes": [1, 4]}
        step = task.make_inference_step()
        # 1 = exact small bucket; 3 = padded to 4; 4 = exact; 6 = split
        # into a 4-chunk + a padded 4-chunk.
        for B in (1, 3, 4, 6):
            batch = _batch(B)
            got = scorer.call(params, export.scoring_inputs(batch))
            assert got.shape == (B,) and got.dtype == np.float32
            _close(got, step(batch).numpy(), atol=1e-6)
        with pytest.raises(ValueError, match="invalid batch_sizes"):
            export.export_scoring_bundle(task, params, _batch(4), batch_sizes=(0, 4))

    def test_bundle_rejects_foreign_zip(self):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("manifest.json", json.dumps({"format": "nope"}))
        with pytest.raises(ValueError):
            export.load_scoring_bundle(buf.getvalue())
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            zf.writestr("bucket_1.bin", b"")
        with pytest.raises(ValueError, match="manifest"):
            export.load_scoring_bundle(buf.getvalue())

    def test_bundle_rejects_a_jax_bundle(self, flax_params):
        jax_task, params = flax_params
        blob = jax_export.export_scoring_bundle(jax_task, params, classification_batch(B=4),
                                                batch_sizes=(1,))
        with pytest.raises(ValueError, match="mmt_tpu_torch.scoring_bundle.v1"):
            export.load_scoring_bundle(blob)


def test_int8_artifact_matches_int8_step(exported):
    """The dynamic-int8 model exports too (its quantization is traced)."""
    _, params, _ = exported
    task = _torch_task(quantize="int8_dynamic")
    task.model.load_state_dict(params)
    art = export.load_scoring(export.export_scoring(task, params, _batch(4)))
    for B in (2, 5):
        _close(art.call(params, _batch(B)), task.make_inference_step()(_batch(B)))


def test_int8_bundle_padding_moves_real_rows_as_in_jax():
    """int8's activation scale is one per tensor over the whole batch, so a
    bundle's zero rows change the real rows' int8 scores, in JAX's bundles
    as in the port's; float scores do not move."""
    for quantize in ("none", "int8_dynamic"):
        jax_task = make_classification_task(quantize=quantize)
        params = jax_task.init(jax.random.PRNGKey(0), classification_batch(B=4))
        jax_scorer = jax_export.load_scoring_bundle(jax_export.export_scoring_bundle(
            jax_task, params, classification_batch(B=4), batch_sizes=(4,)))
        jax_moved = np.abs(jax_scorer.call(params, jax_export.scoring_inputs(
            classification_batch(B=3))) - np.asarray(jax_task.make_inference_step()(
                params, classification_batch(B=3)))).max()
        task = _torch_task(quantize=quantize)
        task.model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                    task.model))
        state = task.model.state_dict()
        scorer = export.load_scoring_bundle(export.export_scoring_bundle(
            task, state, _batch(4), batch_sizes=(4,)))
        moved = np.abs(scorer.call(state, _batch(3))
                       - task.make_inference_step()(_batch(3)).numpy()).max()
        print(f"{quantize}: 3 rows padded to 4 move real scores by {jax_moved} (JAX), "
              f"{moved} (port)")
        if quantize == "none":
            assert jax_moved == moved == 0.0
        else:
            assert jax_moved > 0.0 and moved > 0.0

