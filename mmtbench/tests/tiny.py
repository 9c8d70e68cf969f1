"""Tiny sizes of the benchmark's cells for the CPU tests: two layers of
width 32, 8 x 8 images in 4 x 4 patches (4 patches), 24 positions, the
cells' mixes with text that fits."""

import copy

import torch

ENCODER = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 64, "vocab_size": 1200}
DATA = {"image_size": 8, "patch_size": 4, "max_seq_len": 24, "global_batch_size": 8}
TEXT = {"dist": "lognormal", "median": 8, "sigma": 0.4, "low": 3, "high": 18}

OVERRIDES = {
    "wit-mlm-itm-2d.pretrain": {
        "config": {"task": {"model": {"encoder": {"mmt": ENCODER}},
                            "train_data": {**DATA, "mlm_max_selections_per_seq": 8,
                                           "mpp_max_selections_per_seq": 4}},
                   "trainer": {"micro_batch_size": 4}},
        "traffic": {"text": {"dist": "uniform", "low": 3, "high": 18}}},
    "flickr30k-itm-2d.finetune": {
        "config": {"task": {"model": {"encoder": {"mmt": {
            **ENCODER, "max_absolute_position_embeddings": 40}}},
            "train_data": {**DATA, "global_batch_size": 96}}},
        "traffic": {"text": TEXT}},
    "flickr30k-itm-2d.score": {
        "config": {"task": {"model": {"encoder": {"mmt": {
            **ENCODER, "max_absolute_position_embeddings": 40}}}, "train_data": DATA}},
        "traffic": {"text": TEXT, "images": 10, "batch": 8}},
}


# The score cell's control needs the published width (and many answers) to
# read its full-size gap: two layers of width 768, 16 patches, 128 pairs a
# batch.
WIDE_SCORE = {
    "config": {"task": {"model": {"encoder": {"mmt": {
        "hidden_size": 768, "num_hidden_layers": 2, "num_attention_heads": 12,
        "intermediate_size": 3072, "vocab_size": 1200, "max_absolute_position_embeddings": 64}}},
        "train_data": {"image_size": 16, "patch_size": 4, "max_seq_len": 64}}},
    "traffic": {"text": {"dist": "lognormal", "median": 14, "sigma": 0.4, "low": 5, "high": 46},
                "images": 64, "batch": 128},
}


def overrides(cell: str, compute_dtype: str = "bfloat16") -> dict:
    """The tiny overrides of ``cell``, in ``compute_dtype``."""
    out = copy.deepcopy(OVERRIDES[cell])
    enc = out["config"]["task"]["model"]["encoder"]["mmt"]
    out["config"]["task"]["model"]["encoder"]["mmt"] = {**enc, "compute_dtype": compute_dtype}
    torch.set_num_threads(4)
    return out
