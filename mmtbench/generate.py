"""The general traffic generator: a mix's parameters (``traffic/<mix>.json``)
and a configuration's shapes -> seeded inputs, made on the device in a few
large calls.

Every sequence is [CLS] [PATCH], the image's patches, then text: ``lengths``
= 2 + patches + text wordpieces, the text drawn from the mix's ``text``
distribution ("uniform" over [low, high], or "lognormal" with ``median``
and ``sigma``, rounded and clipped to [low, high]).  Segment ids follow the
loaders' convention (1 on the image part, 2 on the text after the first
text slot, 0 elsewhere).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def seed_of(seed: int, *stream: int) -> int:
    """A 63-bit seed of the stream ``stream`` of a run seeded ``seed`` (any
    whole number; taken modulo 2**64)."""
    entropy = [seed % 2**64, *stream]
    return int(np.random.SeedSequence(entropy).generate_state(2, np.uint64)[0] >> 1)


def text_lengths(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    low, high = spec["low"], spec["high"]
    if spec["dist"] == "uniform":
        return torch.randint(low, high + 1, (n,), generator=gen, device=device)
    if spec["dist"] == "lognormal":
        z = torch.randn(n, generator=gen, device=device)
        x = torch.exp(np.log(spec["median"]) + spec["sigma"] * z)
        return torch.round(x).long().clamp(low, high)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def sequence_lengths(spec: dict, shape, n: int, gen, device) -> torch.Tensor:
    image = 2 + shape["patches"]
    if spec["high"] > shape["seq_len"] - image:
        raise ValueError(f"text up to {spec['high']} does not fit {shape['seq_len']} - {image}")
    return image + text_lengths(spec, n, gen, device)


def segment_ids(lengths: torch.Tensor, shape) -> torch.Tensor:
    pos = torch.arange(shape["seq_len"], device=lengths.device)[None]
    image = 2 + shape["patches"]
    text = (pos > image) & (pos < lengths[:, None])
    return torch.where(pos < image, 1, torch.where(text, 2, 0))


def words(lengths: torch.Tensor, shape, mix, gen) -> torch.Tensor:
    n, dev = len(lengths), lengths.device
    pos = torch.arange(shape["seq_len"], device=dev)[None]
    ids = torch.randint(mix["word_low"], shape["vocab"], (n, shape["seq_len"]), generator=gen,
                        device=dev)
    return ids * (pos < lengths[:, None])


def patches(n: int, shape, gen, device) -> torch.Tensor:
    return torch.randn(n, shape["patches"], shape["patch_dim"], generator=gen, device=device)


def pretraining_batch(mix: dict, shape: dict, rows: int, gen, device) -> Dict[str, torch.Tensor]:
    """MLM + ITM rows: ~``mlm_fraction`` of the real text positions masked
    (the first ``mlm_slots`` selected positions become targets, [MASK] =
    ``mask_id``), no patch targets, ITM labels negative with probability
    ``itm_negative_share``."""
    lengths = sequence_lengths(mix["text"], shape, rows, gen, device)
    ids = words(lengths, shape, mix, gen)
    s, m = shape["seq_len"], shape["mlm_slots"]
    pos = torch.arange(s, device=device)[None]
    text = (pos < lengths[:, None]) & (pos >= 2 + shape["patches"])
    select = text & (torch.rand(rows, s, generator=gen, device=device) < mix["mlm_fraction"])
    order = torch.argsort((~select).int() * s + pos, dim=1)[:, :m]
    weights = torch.gather(select, 1, order).float()
    positions = order * weights.long()
    labels = torch.gather(ids, 1, positions) * weights.long()
    p = shape["mpp_slots"]
    return {
        "word_ids": torch.where(select, torch.full_like(ids, mix["mask_id"]), ids),
        "segment_ids": segment_ids(lengths, shape),
        "patch_embeddings": patches(rows, shape, gen, device),
        "lengths": lengths,
        "mlm_positions": positions, "mlm_label_ids": labels, "mlm_label_weights": weights,
        "mpp_positions": torch.zeros(rows, p, dtype=torch.long, device=device),
        "mpp_label_ids": torch.zeros(rows, p, dtype=torch.long, device=device),
        "mpp_label_weights": torch.zeros(rows, p, device=device),
        "itm_label_ids": (torch.rand(rows, generator=gen, device=device)
                          >= mix["itm_negative_share"]).long(),
        "itm_label_weights": torch.ones(rows, device=device),
    }


def classification_batch(mix: dict, shape: dict, rows: int, gen, device) -> Dict[str, torch.Tensor]:
    """ITM rows, one positive in every 1 + ``negative_positive_ratio``,
    shuffled; positive rows weighted by ``pos_weight``."""
    lengths = sequence_lengths(mix["text"], shape, rows, gen, device)
    period = 1 + mix["negative_positive_ratio"]
    labels = (torch.arange(rows, device=device) % period == 0).long()
    labels = labels[torch.randperm(rows, generator=gen, device=device)]
    return {
        "word_ids": words(lengths, shape, mix, gen),
        "segment_ids": segment_ids(lengths, shape),
        "patch_embeddings": patches(rows, shape, gen, device),
        "lengths": lengths,
        "label_ids": labels,
        "label_weights": torch.ones(rows, device=device),
        "pos_weights": torch.where(labels > 0, mix["pos_weight"], 1.0).float(),
    }


def score_batches(mix: dict, shape: dict, seed: int, device) -> list:
    """``mix["pool"]`` batches of ``mix["batch"]`` consecutive pairs of the
    cross product of ``images`` x ``images * captions_per_image``
    (image-major, as a retrieval pool is scored), at batch positions drawn
    from the seed, as the host arrays that ``eval.predict.predict`` takes,
    page-locked where the device is a card (a pageable copy swung the rate
    by ~10% from run to run).  Caption c describes image
    c // captions_per_image."""
    gen = torch.Generator(device).manual_seed(seed_of(seed, 1))
    images, captions = mix["images"], mix["images"] * mix["captions_per_image"]
    pairs, size = images * captions, mix["batch"]
    cap_len = text_lengths(mix["text"], captions, gen, device) + 2 + shape["patches"]
    cap_words = words(cap_len, shape, mix, gen)
    starts = torch.randperm(pairs // size, generator=gen, device=device)[:mix["pool"]] * size
    pinned = torch.device(device).type == "cuda"
    out = []
    for start in starts.tolist():
        pair = torch.arange(start, start + size, device=device)
        image, caption = pair // captions, pair % captions
        used = torch.unique(image)
        feats = torch.empty(len(used), shape["patches"], shape["patch_dim"], device=device)
        for i, img in enumerate(used.tolist()):
            g = torch.Generator(device).manual_seed(seed_of(seed, 2, img))
            feats[i] = patches(1, shape, g, device)[0]
        lengths = cap_len[caption]
        batch = {
            "word_ids": cap_words[caption].int(),
            "segment_ids": segment_ids(lengths, shape).int(),
            "patch_embeddings": feats[torch.searchsorted(used, image)],
            "lengths": lengths.int(),
            "image_index": image, "text_index": caption,
            "gt_image_index": caption // mix["captions_per_image"],
            "valid": torch.ones(size, dtype=torch.int32, device=device),
        }
        out.append({k: host_array(v, pinned) for k, v in batch.items()})
    return out


def host_array(v: torch.Tensor, pinned: bool) -> np.ndarray:
    """``v`` copied to the host, as a numpy view of a (page-locked where
    ``pinned``) tensor."""
    h = torch.empty(v.shape, dtype=v.dtype, pin_memory=pinned)
    h.copy_(v)
    return h.numpy()
