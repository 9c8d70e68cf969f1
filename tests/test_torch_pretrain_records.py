"""The port's pretraining from records against the JAX package's.

WIT-style records (PNG images, ``canonical_doc_id``, the attribution and
reference captions of 1-12 words, some under the short-text filter's 6
wordpieces) are written from numpy seeds; a tiny encoder (hidden 32, 2
layers, image 32 / patch 16 so 4 patches, S=64) runs the JAX side on the
CPU with its dense attention (``xla``) and the port with ``--device=cpu``
(the fused op's plain version).  Tolerances:

* ``mask_items`` (several specs and seeds, words and patches, the
  label-weight quirk), ``make_mpp_label_ids`` (numpy and torch, values on
  the bucket boundaries), ``MmtPretrainLoader`` batches (MLM + ITM at MPP
  0, MLM + MPP + ITM at 0.5, host and ``ship_raw_images`` modes, training
  and eval, the long4k window yaml's data config), the resumed stream and
  ``multiprocess_batches``: equal, key by key and dtype by dtype;
* the pretraining model on ``images`` + ``patch_mask``: logits within
  1e-4 of JAX's (float32);
* host-mode and raw-mode batches of the same records: the same loss within
  1e-6 (the same float32 operations on the host and in the encoder);
* ``PretrainingTask`` on a record batch: loss and metrics at 1e-5,
  gradients within 1e-4 of each tensor's norm plus 1e-6 of the whole
  gradient's norm (as ``tests/test_torch_train.py``);
* the train CLI on records (``train_and_eval``, micro-batches, RandAugment,
  0 and 2 loader workers): per-step train losses and the validation
  metrics within 1e-4 of ``mmt_tpu.cli.train.main`` from the same
  parameters; ``--mode=eval`` equal to the last validation.
"""

import collections
import io
import itertools
import json
import multiprocessing
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mmt_tpu.configs import PretrainingTaskConfig as JaxTaskConfig
from mmt_tpu.configs import TrainerConfig as JaxTrainerConfig
from mmt_tpu.configs.base import override as jax_override
from mmt_tpu.configs.data import MmtPretrainDataConfig as JaxDataConfig
from mmt_tpu.data.loaders import MmtPretrainLoader as JaxLoader
from mmt_tpu.data.tfrecord import TFRecordWriter, build_example
from mmt_tpu.features import masking as jax_masking
from mmt_tpu.features import patches as jax_patches
from mmt_tpu.train.tasks import PretrainingTask as JaxTask
from mmt_tpu.train.train_state import TrainState as JaxTrainState
from mmt_tpu_torch.configs import PretrainingTaskConfig, TrainerConfig, override
from mmt_tpu_torch.configs.data import MmtPretrainDataConfig
from mmt_tpu_torch.convert import params_from_flax
from mmt_tpu_torch.data.loaders import MmtPretrainLoader
from mmt_tpu_torch.data.prefetch import LoaderShard, multiprocess_batches
from mmt_tpu_torch.features import masking, patches
from mmt_tpu_torch.train.tasks import PretrainingTask, batch_to_device
from mmt_tpu_torch.train.train_state import TrainState
from tests.test_torch_train import _assert_trees_close, _GradRecorder, _to_port_names

REPO = Path(__file__).resolve().parents[1]
WORDS = ["red", "blue", "shirt", "dress", "cotton", "wool", "style", "fashion"]
# Words that split into two wordpieces, for whole-word masking.
SPLIT_WORDS = ["reds", "dressed", "shirts", "blueing", "wools"]
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[ATT]", "[REF]", "[PATCH]", "[PATCH_MASK]"]
    + [f"[unused{i}]" for i in range(99, 300)]  # 196 patch ids for the 224 / 16 geometry
    + WORDS + ["##s", "##ed", "##ing"]
)
S = 64  # image 32 / patch 16: [CLS] [PATCH] 4 patches, then text
ENCODER = dict(
    vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, relative_pos_max_distance=3, relative_vocab_size=12,
    relative_att_num_core_layers=1, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0, compute_dtype="float32",
)
HEAD = {"inner_dim": 32, "num_classes": 2, "name": "itm"}


def _png(rng, height, width):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def write_wit_records(path, n, seed, sizes=((32, 32),)):
    """WIT-style records: two records per ``canonical_doc_id``, an
    attribution caption of 1-12 words and, on two records of three, a
    reference caption of 1-4 words; every fifth record has one word alone
    (under the short-text filter's 6 wordpieces)."""
    rng = np.random.default_rng(seed)
    pool = WORDS + SPLIT_WORDS
    with TFRecordWriter(str(path)) as w:
        for i in range(n):
            height, width = sizes[i % len(sizes)]
            short = i % 5 == 4
            words = 1 if short else int(rng.integers(1, 13))
            feats = {"image_data": [_png(rng, height, width)],
                     "canonical_doc_id": [f"doc{seed}_{i // 2}".encode()],
                     "caption_attribution_description": [
                         " ".join(rng.choice(pool, size=words)).encode()]}
            if i % 3 and not short:
                feats["caption_reference_description"] = [
                    " ".join(rng.choice(pool, size=int(rng.integers(1, 5)))).encode()]
            w.write(build_example(feats))
    return str(path)


def data_dict(vocab, input_path, **kw):
    base = dict(vocab_filename=vocab, input_path=input_path, image_size=32, patch_size=16,
                max_seq_len=S, seed=7, global_batch_size=16, shuffle_buffer_size=12,
                image_key_field="canonical_doc_id", tasks="mlm,itm", mpp_fraction_to_mask=0.0,
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
    root = tmp_path_factory.mktemp("wit_records")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    return {"root": root, "vocab": str(vocab),
            "train": write_wit_records(root / "train.tfrecord", 48, seed=0),
            "val": write_wit_records(root / "val.tfrecord", 40, seed=1),
            "mixed": write_wit_records(root / "mixed.tfrecord", 24, seed=2,
                                       sizes=((32, 32), (48, 40), (20, 56)))}


# ----------------------------------------------------------- host pieces

SPECS = {
    "mlm": dict(vocab_size=40, mask_token_id=4, selection_rate=0.15, max_selections=64),
    "capped": dict(vocab_size=40, mask_token_id=4, selection_rate=0.5, max_selections=3),
    "choices": dict(vocab_size=40, mask_token_id=4, selection_rate=1.0, max_selections=99,
                    mask_prob=0.5, random_prob=0.3),
    "none": dict(vocab_size=40, mask_token_id=4, selection_rate=0.0, max_selections=99),
}


@pytest.mark.parametrize("kind", ["words", "patches"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_mask_items_matches(spec, kind):
    for seed in range(4):
        rng = np.random.default_rng(seed)
        if kind == "words":
            items = [rng.integers(5, 40, int(rng.integers(1, 4))).astype(np.int32)
                     for _ in range(int(rng.integers(0, 15)))]
        else:
            items = rng.integers(5, 40, 12).astype(np.int32)
        selectable = rng.random(len(items)) < 0.8
        got_rng, want_rng = np.random.default_rng(100 + seed), np.random.default_rng(100 + seed)
        got = masking.mask_items(items, masking.MaskingSpec(**SPECS[spec]), got_rng, selectable)
        want = jax_masking.mask_items(items, jax_masking.MaskingSpec(**SPECS[spec]), want_rng,
                                      selectable)
        for field in ("token_ids", "positions", "label_ids", "label_weights"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
            assert getattr(got, field).dtype == getattr(want, field).dtype, field
        assert got_rng.random() == want_rng.random()  # the same draws consumed
        # The quirk: weight 1 for the first count(mask token) selections.
        n_masks = int(np.sum(got.token_ids == SPECS[spec]["mask_token_id"]))
        np.testing.assert_array_equal(got.label_weights,
                                      np.arange(len(got.positions)) < n_masks)


def test_pad_1d_is_the_masking_modules():
    from mmt_tpu_torch.data import loaders

    assert loaders.pad_1d is masking.pad_1d
    x = np.arange(5, dtype=np.int32)
    for length in (3, 5, 8):
        got, want = masking.pad_1d(x, length), jax_masking.pad_1d(x, length)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("bits", [2, 3])
def test_mpp_label_ids_match(bits):
    rng = np.random.default_rng(bits)
    p, n = 4, 10
    u8 = rng.integers(0, 256, (2, n, p * p * 3), dtype=np.uint8)
    # Patches at the bucket boundaries: every pixel of a channel equal to
    # a boundary value (and one below it).
    bin_size = 256 // 2**bits
    for j, v in enumerate(range(0, 256, bin_size)):
        u8[0, j % n] = v
        u8[1, j % n] = max(v - 1, 0)
    values = np.true_divide(u8, 255, dtype=np.float32)
    want = jax_patches.make_mpp_label_ids(values, p, output_channel_bits=bits)
    got = patches.make_mpp_label_ids(values, p, output_channel_bits=bits)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    want_jnp = np.asarray(jax_patches.make_mpp_label_ids(jnp.asarray(values), p,
                                                         output_channel_bits=bits))
    got_torch = patches.make_mpp_label_ids(torch.from_numpy(values), p,
                                           output_channel_bits=bits)
    assert got_torch.dtype == torch.int32
    np.testing.assert_array_equal(got_torch.numpy(), want_jnp)
    np.testing.assert_array_equal(got_torch.numpy(), got)
    assert len(np.unique(got)) > 4


# ---------------------------------------------------------------- loader

LOADER_CASES = {
    "yaml_mlm_itm": dict(tasks="mlm,itm", mpp_fraction_to_mask=0.0, use_rand_aug=True),
    "mpp": dict(tasks="mlm,mpp,itm", mpp_fraction_to_mask=0.5),
    "mpp_raw": dict(tasks="mlm,mpp,itm", mpp_fraction_to_mask=0.5, ship_raw_images=True),
    "mpp_eval": dict(tasks="mlm,mpp,itm", mpp_fraction_to_mask=0.5, is_training=False),
    "mpp_raw_eval": dict(tasks="mlm,mpp,itm", mpp_fraction_to_mask=0.5, is_training=False,
                         ship_raw_images=True),
    "mlm_only": dict(tasks="mlm", mpp_fraction_to_mask=0.5, use_patch_mask_token_id=True),
    "resized": dict(tasks="mlm,mpp,itm", mpp_fraction_to_mask=0.5, use_rand_aug=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_pretrain_loader_batches_match(records, case):
    path = records["mixed" if case == "resized" else "train"]
    kw = data_dict(records["vocab"], path, **LOADER_CASES[case])
    got = take(MmtPretrainLoader(MmtPretrainDataConfig(**kw)).load(), 3)
    want = take(JaxLoader(JaxDataConfig(**kw)).load(), 3)
    assert_batches_equal(got, want)
    b = got[0]
    raw = kw.get("ship_raw_images", False)
    image_keys = {"images", "patch_mask"} if raw else {"patch_embeddings"}
    assert image_keys <= b.keys() and not ({"images", "patch_embeddings"} - image_keys) & b.keys()
    assert b["word_ids"].shape == (16, S)
    if "itm" in kw["tasks"]:
        assert set(np.unique(b["itm_label_ids"])) == {0, 1}
    if kw["mpp_fraction_to_mask"] > 0:
        assert b["mpp_label_weights"].sum() > 0
    else:
        assert not b["mpp_label_weights"].any()
    assert b["mlm_label_weights"].sum() > 0


def test_short_text_filter_drops_examples(records):
    """Records whose captions make fewer than 6 wordpieces are skipped, so
    a batch of 16 consumes more records than 16, as in JAX."""
    kw = data_dict(records["vocab"], records["train"], tasks="mlm", is_training=False)
    stream = MmtPretrainLoader(MmtPretrainDataConfig(**kw)).stream()
    jax_stream = JaxLoader(JaxDataConfig(**kw)).stream()
    assert_batches_equal([next(stream)], [next(jax_stream)])
    assert stream._cursor.pos == jax_stream._cursor.pos > 16
    assert (next(stream)["lengths"] >= 2 + 4 + 6).all()
    with pytest.raises(StopIteration):  # the split, read once, ends
        take(stream, 3)


def test_long4k_window_yaml_data_config(records):
    """The data half of mlm_itm_2d_long4k_window.yaml (S=4096, image 224,
    RandAugment) with only the paths and a small batch changed."""
    exp = yaml.safe_load((REPO / "configs/exp_yamls/pretrain/wit/"
                                 "mlm_itm_2d_long4k_window.yaml").read_text())
    kw = {**exp["task"]["train_data"], "input_path": records["mixed"],
          "vocab_filename": records["vocab"], "global_batch_size": 16, "shuffle_buffer_size": 8}
    got = take(MmtPretrainLoader(MmtPretrainDataConfig(**kw)).load(), 2)
    want = take(JaxLoader(JaxDataConfig(**kw)).load(), 2)
    assert_batches_equal(got, want)
    assert got[0]["word_ids"].shape == (16, 4096)
    assert got[0]["patch_embeddings"].shape == (16, 196, 768)


def test_shuffle_buffer_frees_nearly_spent_matched_batches(records):
    """Rows waiting in the shuffle buffer are views of their matched batch
    until only 1 / _COMPACT_SHARE of its rows wait; those are then copies,
    so the batch is freed.  The batches stay equal to JAX's (whose rows
    stay views)."""
    from mmt_tpu_torch.data.loaders import _COMPACT_SHARE

    kw = data_dict(records["vocab"], records["train"], tasks="mlm,mpp,itm",
                   mpp_fraction_to_mask=0.5, global_batch_size=64, shuffle_buffer_size=96)
    stream = MmtPretrainLoader(MmtPretrainDataConfig(**kw)).stream()
    jax_stream = JaxLoader(JaxDataConfig(**kw)).stream()
    rows_per_matched = 64  # 32 records matched at ratio 1
    views_seen = copies_seen = 0
    for _ in range(12):
        assert_batches_equal([next(stream)], [next(jax_stream)])
        waiting = collections.defaultdict(list)
        for it in [*stream._shufbuf, *stream._pending]:
            waiting[it.bid].append(it.row["patch_embeddings"].base is None)
        for copied in waiting.values():
            assert len(set(copied)) == 1  # all of a batch's rows, or none
            if len(copied) <= rows_per_matched // _COMPACT_SHARE:
                assert copied[0]
            copies_seen += copied[0]
            views_seen += not copied[0]
    assert views_seen and copies_seen


# Batch 8 as tests/test_data_resume.py; batch 32 (32-row matched batches)
# also copies nearly spent matched batches' rows out, before and after
# the restore.
@pytest.fixture(scope="module", params=[(8, 12), (32, 40)], ids=["batch8", "batch32"])
def resume_setup(tmp_path_factory, request):
    batch, buffer = request.param
    root = tmp_path_factory.mktemp("wit_resume")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    write_wit_records(root / "a.tfrecord", 13, seed=3)
    write_wit_records(root / "b.tfrecord", 9, seed=4)
    cfg = MmtPretrainDataConfig(**data_dict(
        str(vocab), str(root / "*.tfrecord"), global_batch_size=batch,
        shuffle_buffer_size=buffer, tasks="mlm_mpp_itm", mpp_fraction_to_mask=0.5, min_shift=1))
    want = take(MmtPretrainLoader(cfg).stream(), 20)
    assert_batches_equal(want, take(JaxLoader(JaxDataConfig(**cfg.as_dict())).stream(), 20))
    return cfg, want


@pytest.mark.parametrize("cut", [1, 5, 11])
def test_pretrain_stream_resume_exact(resume_setup, cut):
    cfg, want = resume_setup
    run1 = MmtPretrainLoader(cfg).stream()
    take(run1, cut)
    st = pickle.loads(pickle.dumps(run1.state()))
    run2 = MmtPretrainLoader(cfg).stream()  # a fresh process's loader
    run2.restore(st)
    assert_batches_equal(take(run2, 20 - cut), want[cut:])


# ------------------------------------------------------- model and task


def task_dict(attention_impl, **data):
    return {
        "model": {"encoder": {"type": "mmt", "mmt": {**ENCODER, "attention_impl": attention_impl}},
                  "cls_heads": [HEAD]},
        "train_data": {"image_size": 32, "patch_size": 16, "max_seq_len": S, **data},
    }


def record_batch(records, **kw):
    cfg = MmtPretrainDataConfig(**data_dict(records["vocab"], records["train"],
                                            tasks="mlm,mpp,itm", mpp_fraction_to_mask=0.5, **kw))
    return next(MmtPretrainLoader(cfg).load())


_PARAMS = {}


def make_tasks(records, micro=0):
    """The JAX task (dense attention), the port's on the CPU with the JAX
    parameters (initialised once from a record batch), and the parameters."""
    trainer = {"train_steps": 3, "micro_batch_size": micro}
    jax_task = JaxTask(jax_override(JaxTaskConfig(), task_dict("xla")),
                       jax_override(JaxTrainerConfig(), trainer))
    task = PretrainingTask(override(PretrainingTaskConfig(), task_dict("pallas")),
                           override(TrainerConfig(), trainer), device="cpu")
    if "params" not in _PARAMS:
        batch = {k: jnp.asarray(v) for k, v in record_batch(records).items()}
        _PARAMS["params"] = jax.tree_util.tree_map(
            np.asarray, jax_task.init(jax.random.PRNGKey(0), batch))
    task.model.load_state_dict(params_from_flax(_PARAMS["params"], task.model))
    return jax_task, task, _PARAMS["params"]


def test_model_images_and_patch_mask_match_jax(records):
    """The raw-image path with MPP's patch mask: the pretraining model's
    logits against JAX's model on the same inputs."""
    jax_task, task, params = make_tasks(records)
    batch = record_batch(records, ship_raw_images=True)
    assert batch["patch_mask"].any() and not batch["patch_mask"].all()
    keys = ("word_ids", "segment_ids", "lengths", "images", "patch_mask", "mlm_positions",
            "mpp_positions")
    want = jax_task.model.apply(params, **{k: jnp.asarray(batch[k]) for k in keys},
                                deterministic=True)
    task.model.eval()
    with torch.no_grad():
        got = task.model(**{k: torch.from_numpy(batch[k]) for k in keys})
    for key in ("mlm_logits", "mpp_logits", "itm_logits", "sequence_output"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    # The mask matters: without it the logits move.
    with torch.no_grad():
        unmasked = task.model(**{k: torch.from_numpy(batch[k]) for k in keys
                                 if k != "patch_mask"})
    moved = (unmasked["sequence_output"] - got["sequence_output"]).abs().amax(dim=(1, 2))
    np.testing.assert_array_equal(moved.numpy() > 1e-2, batch["patch_mask"].any(axis=1))


def test_raw_and_host_batches_give_the_same_loss(records):
    _, task, _ = make_tasks(records)
    host = record_batch(records)
    raw = record_batch(records, ship_raw_images=True)
    assert host.keys() - raw.keys() == {"patch_embeddings"}
    assert raw.keys() - host.keys() == {"images", "patch_mask"}
    for key in host.keys() & raw.keys():
        np.testing.assert_array_equal(host[key], raw[key], err_msg=key)
    losses = {}
    for name, batch in (("host", host), ("raw", raw)):
        loss, (_, metrics) = task.compute_loss(batch_to_device(batch, "cpu"), None, True)
        losses[name] = (loss.item(), {k: v[0].item() for k, v in metrics.items()})
    np.testing.assert_allclose(losses["raw"][0], losses["host"][0], rtol=0, atol=1e-6)
    for key, value in losses["host"][1].items():
        np.testing.assert_allclose(losses["raw"][1][key], value, rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("raw", [False, True], ids=["host", "raw"])
def test_task_loss_metrics_and_grads_match_on_records(records, raw):
    jax_task, task, params = make_tasks(records, micro=8)
    batch = record_batch(records, ship_raw_images=raw)
    # JAX: one SGD step of rate 1 gives params - grads.
    jstate = JaxTrainState.create(params, optax.sgd(1.0))
    jnew, jmetrics = jax_task.make_train_step(micro_batch_size=8)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want_grads = _to_port_names(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, jnew.params), task.model)
    recorder = _GradRecorder(task.model)
    state = TrainState(step=0, model=task.model, optimizer=recorder)
    state, metrics = task.make_train_step(8)(state, batch_to_device(batch, "cpu"))
    assert metrics.keys() == jmetrics.keys()
    for name, (total, count) in jmetrics.items():
        np.testing.assert_allclose(metrics[name][0].item(), float(total), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(metrics[name][1].item(), float(count), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    _assert_trees_close(recorder.grads, want_grads, 1e-4, floor=1e-6)

    jeval = jax_task.make_eval_step()(params, {k: jnp.asarray(v) for k, v in batch.items()})
    task.model.load_state_dict(params_from_flax(params, task.model))
    got = task.make_eval_step()(batch_to_device(batch, "cpu"))
    assert got.keys() == jeval.keys()  # metric pairs only, as JAX's
    for name, (total, count) in jeval.items():
        np.testing.assert_allclose(got[name][0].item() / got[name][1].item(),
                                   float(total) / float(count), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- prefetch


def _interleave(*streams):
    out = []
    for group in itertools.zip_longest(*streams):
        out.extend(b for b in group if b is not None)
    return out


def test_multiprocess_batches_are_the_shard_union(records):
    cfg = MmtPretrainDataConfig(**data_dict(
        records["vocab"], ",".join([records["train"], records["val"]]), tasks="mlm,mpp",
        mpp_fraction_to_mask=0.5, is_training=False, global_batch_size=4))
    loader_fn = LoaderShard(MmtPretrainLoader, cfg)
    parallel = list(multiprocess_batches(loader_fn, num_workers=2))
    serial = [list(loader_fn(i, 2)) for i in range(2)]
    assert len(serial[0]) and len(serial[1])
    # Round-robin over the workers: the shard streams interleaved.
    assert_batches_equal(parallel, _interleave(*serial))
    assert not multiprocessing.active_children()
    # Zero workers: the loader itself, in this process.
    assert_batches_equal(list(multiprocess_batches(loader_fn, num_workers=0)),
                         list(loader_fn(0, 1)))


def test_multiprocess_batches_free_their_blocks_when_closed(records):
    """Closing the stream mid-way stops the workers and unlinks every
    shared-memory block they made, queued ones included."""
    import os
    import time

    cfg = MmtPretrainDataConfig(**data_dict(records["vocab"], records["train"]))
    stream = multiprocess_batches(LoaderShard(MmtPretrainLoader, cfg), num_workers=2)
    first = next(stream)
    assert_batches_equal([first], take(MmtPretrainLoader(cfg).load(0, 2), 1))
    time.sleep(3)  # the workers queue more blocks
    stream.close()
    assert not multiprocessing.active_children()
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(f"mmt_{os.getpid()}_")]
    np.testing.assert_array_equal(first["word_ids"], first["word_ids"].copy())  # still mapped


class _ExitingLoader:
    """A loader function whose process dies before it sends anything."""

    def __call__(self, shard, num_shards):
        import os

        os._exit(3)


def test_multiprocess_batches_raise_for_a_failed_or_silent_worker(records, tmp_path,
                                                                  monkeypatch):
    bad = MmtPretrainDataConfig(**data_dict(records["vocab"], str(tmp_path / "none*.tfrecord")))
    with pytest.raises(RuntimeError, match="does not match any files"):
        list(multiprocess_batches(LoaderShard(MmtPretrainLoader, bad), num_workers=2))
    cfg = MmtPretrainDataConfig(**data_dict(records["vocab"], records["train"]))
    from mmt_tpu_torch.data import prefetch

    with monkeypatch.context() as m:
        m.setattr(prefetch, "WORKER_TIMEOUT_S", 0.001)
        with pytest.raises(RuntimeError, match="sent nothing"):
            next(multiprocess_batches(LoaderShard(MmtPretrainLoader, cfg), num_workers=1))
    with pytest.raises(RuntimeError, match="exited with code 3"):
        next(multiprocess_batches(_ExitingLoader(), num_workers=1))
    assert not multiprocessing.active_children()


# ------------------------------------------------------------------ CLI


def test_chip_smoke_records_experiment_is_the_wit_2d_yaml(tmp_path):
    """chip_smoke.py's records experiment is mlm_itm_2d.yaml with its
    placeholders filled and only the schedule and the depth cut (and the
    worker count)."""
    import chip_smoke
    from mmt_tpu_torch.configs import get_experiment_config
    from mmt_tpu_torch.configs.base import from_yaml_file

    path = REPO / "configs/exp_yamls/pretrain/wit/mlm_itm_2d.yaml"
    want = from_yaml_file(get_experiment_config("mmt/pretraining"), str(path)).as_dict()
    got = override(get_experiment_config("mmt/pretraining"),
                   chip_smoke.wit_records_experiment(tmp_path, num_workers=3)).as_dict()
    assert got["task"]["train_data"]["num_workers"] == 3
    assert got["task"]["train_data"]["input_path"] == str(tmp_path / "train-*.tfrecord")
    assert got["task"]["model"]["encoder"]["mmt"]["num_hidden_layers"] == chip_smoke.PR_LAYERS
    for section in (want, got):
        section["task"]["model"]["encoder"]["mmt"]["num_hidden_layers"] = None
        for split in ("train_data", "validation_data"):
            section["task"][split].update(input_path=None, vocab_filename=None, num_workers=None)
        for key in ("train_steps", "steps_per_loop", "summary_interval", "validation_interval",
                    "validation_steps"):
            section["trainer"][key] = None
    assert got == want

OPT = {"polynomial": {"initial_learning_rate": 1e-3, "decay_steps": 10},
       "warmup": {"warmup_steps": 1}}
METRICS = ("mlm_loss", "mpp_loss", "itm_loss", "mlm_accuracy", "mpp_accuracy", "itm_accuracy",
           "total_loss")


def cli_yaml(records, attention_impl, init_checkpoint, steps=4, num_workers=0):
    data = data_dict(records["vocab"], records["train"], tasks="mlm,mpp,itm",
                     mpp_fraction_to_mask=0.5, use_rand_aug=True, num_workers=num_workers)
    return {
        "task": {
            "init_checkpoint": init_checkpoint,
            "model": {"encoder": {"type": "mmt", "mmt": {**ENCODER,
                                                         "attention_impl": attention_impl}},
                      "cls_heads": [HEAD]},
            "train_data": data,
            "validation_data": {**data, "input_path": records["val"], "is_training": False,
                                "use_rand_aug": False, "num_workers": 0}},
        "trainer": {"train_steps": steps, "steps_per_loop": 1, "summary_interval": 1,
                    "checkpoint_interval": 2, "validation_interval": 2, "validation_steps": -1,
                    "micro_batch_size": 8, "max_to_keep": 8, "optimizer_config": OPT},
        # JAX: one device, where its warm start puts the parameters.
        "runtime": {"num_data_parallel": 1}}


def _read_jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def run_both_clis(records, tmp_path, num_workers, mode="train_and_eval"):
    from mmt_tpu.cli.train import main as jax_main
    from mmt_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from mmt_tpu_torch.cli.train import main
    from mmt_tpu_torch.train.checkpoint import CheckpointManager

    _, task, params = make_tasks(records)
    JaxCheckpointManager(str(tmp_path / "jax_init")).save(0, params)
    CheckpointManager(str(tmp_path / "torch_init")).save(0, task.model)
    for name, impl in (("jax", "xla"), ("torch", "pallas")):
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(cli_yaml(
            records, impl, str(tmp_path / f"{name}_init"), num_workers=num_workers)))
    jax_main(["--experiment=mmt/pretraining", f"--mode={mode}",
              f"--model_dir={tmp_path / 'jax_model'}", f"--config_file={tmp_path / 'jax.yaml'}"])
    state = main(["--experiment=mmt/pretraining", f"--mode={mode}",
                  f"--model_dir={tmp_path / 'torch_model'}",
                  f"--config_file={tmp_path / 'torch.yaml'}", "--device=cpu"])
    assert state.step == 4
    assert not multiprocessing.active_children()
    return tmp_path / "jax_model", tmp_path / "torch_model"


def assert_summaries_close(got, want, steps, keys):
    assert [r["step"] for r in got] == [r["step"] for r in want] == steps
    for g, w in zip(got, want):
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4,
                                       err_msg=f"{key} at step {g['step']}")


def test_cli_pretraining_from_records_matches_jax(records, tmp_path, capsys):
    """The slice as a whole: both CLIs from the same parameters on the same
    records and yaml, 4 steps of 2 micro-batches with dropout 0, validation
    at steps 2 and 4."""
    from mmt_tpu_torch.cli.train import main

    jax_dir, torch_dir = run_both_clis(records, tmp_path, num_workers=0)
    for name in ("params.yaml", "train_summaries.jsonl", "validation_summaries.jsonl", "2", "4",
                 "data_stream"):
        assert (jax_dir / name).exists() and (torch_dir / name).exists(), name
    assert_summaries_close(_read_jsonl(torch_dir / "train_summaries.jsonl"),
                           _read_jsonl(jax_dir / "train_summaries.jsonl"), [1, 2, 3, 4], METRICS)
    got = _read_jsonl(torch_dir / "validation_summaries.jsonl")
    assert_summaries_close(got, _read_jsonl(jax_dir / "validation_summaries.jsonl"), [2, 4],
                           METRICS)
    assert "auc" not in got[-1]

    capsys.readouterr()
    metrics = main(["--experiment=mmt/pretraining", "--mode=eval", f"--model_dir={torch_dir}",
                    f"--config_file={tmp_path / 'torch.yaml'}", "--device=cpu"])
    assert str(metrics) in capsys.readouterr().out
    assert metrics == {k: v for k, v in got[-1].items() if k != "step"}


def test_cli_pretraining_with_two_workers_matches_jax(records, tmp_path):
    """num_workers=2 in both packages: the same shards, round-robin, so the
    same batches and losses; the port's workers are stopped at the end."""
    jax_dir, torch_dir = run_both_clis(records, tmp_path, num_workers=2, mode="train")
    assert_summaries_close(_read_jsonl(torch_dir / "train_summaries.jsonl"),
                           _read_jsonl(jax_dir / "train_summaries.jsonl"), [1, 2, 3, 4], METRICS)
    assert not (torch_dir / "data_stream").exists()  # the worker stream has no state()


def test_cli_classification_with_two_workers_runs(tmp_path):
    from mmt_tpu_torch.cli.train import main
    from tests.test_torch_finetune import cli_yaml as itm_yaml
    from tests.test_torch_finetune import write_paired_records, write_vocab

    vocab = write_vocab(tmp_path)
    train = write_paired_records(tmp_path / "train.tfrecord", 40, seed=0)
    val = write_paired_records(tmp_path / "val.tfrecord", 16, seed=1)
    experiment = itm_yaml(vocab, train, val, "pallas", steps=2)
    experiment["task"]["train_data"]["num_workers"] = 2
    (tmp_path / "itm.yaml").write_text(yaml.safe_dump(experiment))
    state = main(["--experiment=mmt/classification", "--mode=train_and_eval",
                  f"--model_dir={tmp_path / 'm'}", f"--config_file={tmp_path / 'itm.yaml'}",
                  "--device=cpu"])
    assert state.step == 2
    assert not multiprocessing.active_children()
    train_log = _read_jsonl(tmp_path / "m" / "train_summaries.jsonl")
    val_log = _read_jsonl(tmp_path / "m" / "validation_summaries.jsonl")
    assert [r["step"] for r in train_log] == [1, 2] and [r["step"] for r in val_log] == [2]
    assert all(np.isfinite(r["cls_loss"]) for r in train_log) and "auc" in val_log[0]
