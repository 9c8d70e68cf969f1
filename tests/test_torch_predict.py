"""The port's results.csv / recall.json writer against the JAX package's.

The same RawResult rows go through both ``write_results``: results.csv
must be byte-identical (the JAX one writes it with pandas) and
recall.json equal.  Also drives the port's ``predict`` on a tiny model.
"""

import json

import numpy as np
import pytest
import torch

from mmt_tpu.eval.predict import RawResult as JaxRawResult
from mmt_tpu.eval.predict import write_results as jax_write_results
from mmt_tpu_torch.configs import (
    ClassificationModelConfig,
    ClsHeadConfig,
    EncoderConfig,
    MmtEncoderConfig,
)
from mmt_tpu_torch.eval import predict as torch_predict
from mmt_tpu_torch.eval.recall import get_recall_at_k
from mmt_tpu_torch.models import MmtClassificationModel


def _rows(n_images, n_texts, seed, hit_all=False, miss_all=False, extremes=False):
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n_texts):
        gt = t % n_images
        if miss_all:
            gt = n_images + 7  # no ground truth in the pool
        for i in range(n_images):
            score = float(rng.random())
            if hit_all and i == gt:
                score = 2.0
            rows.append((i, t, gt, score))
    if extremes:
        rows += [(0, n_texts, 0, -0.5), (1, n_texts, 0, 1.5), (2, n_texts, 0, 1e-12),
                 (3, n_texts, 0, 0.123456789), (0, n_texts + 1, 1, float("nan")),
                 (1, n_texts + 1, 1, -0.0), (0, 0, 0, 0.5)]  # a duplicate (0, 0) pair
    return rows


@pytest.mark.parametrize("case", [
    dict(n_images=5, n_texts=7, seed=0),
    dict(n_images=4, n_texts=4, seed=1, hit_all=True),
    dict(n_images=3, n_texts=6, seed=2, miss_all=True),
    dict(n_images=6, n_texts=5, seed=3, extremes=True),
], ids=["random", "all_hit", "all_miss_nan", "extremes_and_duplicates"])
def test_write_results_matches_jax(tmp_path, case):
    rows = _rows(**case)
    want = jax_write_results((JaxRawResult(*r) for r in rows), str(tmp_path / "jax"))
    got = torch_predict.write_results((torch_predict.RawResult(*r) for r in rows),
                                      str(tmp_path / "torch"))
    assert got == want
    assert (tmp_path / "torch" / "results.csv").read_bytes() == \
        (tmp_path / "jax" / "results.csv").read_bytes()
    assert json.loads((tmp_path / "torch" / "recall.json").read_text()) == \
        json.loads((tmp_path / "jax" / "recall.json").read_text())
    if case.get("miss_all"):
        assert set(got.values()) == {"nan"}


def test_recall_numpy_matches_formatted_keys():
    rows = np.asarray(_rows(4, 3, seed=4))
    got = get_recall_at_k(rows[:, 0].astype(int), rows[:, 1].astype(int),
                          rows[:, 2].astype(int), rows[:, 3])
    assert list(got) == [f"{d} @ {k:>2}" for d in ("i2t", "t2i") for k in (1, 3, 5, 10)]


def test_predict_scores_valid_rows(tmp_path):
    cfg = ClassificationModelConfig(
        encoder=EncoderConfig(mmt=MmtEncoderConfig(
            vocab_size=50, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, relative_pos_max_distance=3, relative_vocab_size=20,
            relative_att_num_core_layers=1, attention_impl="pallas")),
        num_classes=2, cls_heads=[ClsHeadConfig(inner_dim=32, num_classes=2, name="itm")])
    model = MmtClassificationModel(cfg, num_patch_per_row=2, patch_dim=12, device="cpu")
    rng = np.random.default_rng(0)
    batch = dict(
        word_ids=rng.integers(0, 50, (3, 16)).astype(np.int32),
        patch_embeddings=rng.normal(size=(3, 4, 12)).astype(np.float32),
        lengths=np.asarray([16, 9, 12], np.int32),
        image_index=np.asarray([0, 1, 0]), text_index=np.asarray([0, 0, 1]),
        gt_image_index=np.asarray([0, 0, 1]), valid=np.asarray([1, 1, 0]),
    )
    results = list(torch_predict.predict(model, [batch], device="cpu"))
    assert [(r.image_index, r.text_index) for r in results] == [(0, 0), (1, 0)]
    with torch.no_grad():
        logits = model(**{k: torch.from_numpy(batch[k]) for k in
                          ("word_ids", "patch_embeddings", "lengths")})["itm_logits"]
    want = torch.softmax(logits, -1)[:2, 1].numpy()
    np.testing.assert_allclose([r.output for r in results], want, rtol=1e-6)
    recall = torch_predict.write_results(results, str(tmp_path))
    assert len(recall) == 8
