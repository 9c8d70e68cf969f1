"""Task dataloaders: pretraining (MLM + MPP + ITM), classification (ITM
finetuning) and retrieval.

The port's own copy of ``mmt_tpu/data/loaders.py`` (``_glob_shard``,
``_segment_ids``, ``RecordCursor``, ``_BaseLoader``, ``MmtPretrainLoader``,
``MmtClassificationLoader``, ``MmtRetrievalLoader``, ``TrainStream``,
``ResumablePrefixed``): host-side numpy pipelines (glob -> shard -> decode
-> filter -> mask -> match -> batch) yielding dicts of numpy arrays that the
training or prediction loop moves to its device.

* No [S, S] side inputs: batches carry ``lengths`` (+ host-cheap
  ``segment_ids``); the model derives masks and ids on the device.
* Training batches come from a checkpointable ``TrainStream``
  (``state()`` / ``restore()``), so that a resumed run consumes exactly
  the batches the uninterrupted run would have.
* Pretraining draws from one numpy rng per stream in the JAX package's
  order: the decode's flip and RandAugment, then MPP, then MLM, then the
  post-match shuffle, so that the same records and seed give the same
  batches in both packages.  With ``ship_raw_images`` its batches carry
  the uint8 ``images`` and a ``patch_mask`` (the MPP zeroing runs in the
  encoder) in place of ``patch_embeddings``.
* Classification in eval yields the split's last, partial matched batch
  when ``drop_remainder`` is false, as the reference's
  ``classification_dataloader.py`` does (the JAX package drops it).
* Retrieval's ``drop_remainder=False`` final partial batch is padded to
  the batch size with a ``valid`` mask (the host filters on it), so that
  every batch has one shape.

Several worker processes: ``data.prefetch.multiprocess_batches``.
"""

from __future__ import annotations

import collections
import copy
import glob as globlib
import itertools
from typing import Dict, Iterator, List, Optional

import numpy as np

from mmt_tpu_torch.configs.data import (
    MmtClassificationDataConfig,
    MmtDataConfig,
    MmtPretrainDataConfig,
    MmtRetrievalDataConfig,
)
from mmt_tpu_torch.data.assembly import AssembledExample, ExampleAssembler
from mmt_tpu_torch.data.tfrecord import (
    TFRecordReader,
    iter_open_records,
    parse_example,
    skim_open,
)
from mmt_tpu_torch.features.masking import MaskingSpec, mask_items, pad_1d
from mmt_tpu_torch.features.matching import make_matching_features
from mmt_tpu_torch.features.patches import make_mpp_label_ids
from mmt_tpu_torch.text.native import NativeBertTokenizer
from mmt_tpu_torch.text.wordpiece import BertTokenizer


def _glob_shard(
    patterns: str | List[str], shard_index: int, num_shards: int,
    seed: Optional[int] = None, epoch: int = 0,
) -> List[str]:
    if isinstance(patterns, str):
        patterns = [p for p in patterns.split(",") if p]
    files: List[str] = []
    for p in patterns:
        matched = sorted(globlib.glob(p))
        if not matched:
            raise ValueError(f"{p} does not match any files.")
        files.extend(matched)
    if seed is not None:
        # Shard-INDEPENDENT file order: every shard must walk the same
        # sequence for files[shard::n] slices to be disjoint and for
        # record-striding to stride one identical record stream.  (A
        # shard-dependent rng here made both branches non-disjoint.)
        # Epoch-varied so repeat still reshuffles between epochs, in
        # lockstep across shards (tf.data list_files(shuffle, seed)
        # semantics, src/data/pretrain_dataloader.py:112-122).
        order = np.random.default_rng(
            (int(seed) + epoch * 1000003) & 0x7FFFFFFF
        )
        order.shuffle(files)
    if len(files) < num_shards:
        # Fewer files than input pipelines: file-level sharding would
        # starve some shards (a multi-host process would then hang its
        # peers' collectives).  Signal record-level striding instead.
        return files, True
    return files[shard_index::num_shards], False


def _unbatch(batch: Dict[str, np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
    n = len(next(iter(batch.values())))
    for i in range(n):
        yield {k: v[i] for k, v in batch.items()}


# A row in the shuffle buffer is a view of its matched batch and keeps all
# of it alive: with a buffer of 4096 rows, the last rows of a matched batch
# leave it ~ln(4096) = 8 matched batches later (8 x 2.47 GB at the WIT
# yaml's 4096).  Once only 1 / _COMPACT_SHARE of a matched batch's rows
# wait, TrainStream copies them out and the batch is freed: ~3 matched
# batches stay alive, for copies of ~6% of the rows.
_COMPACT_SHARE = 16


def _segment_ids(max_seq_len: int, img_wp: int, txt_wp: int) -> np.ndarray:
    """Host copy of features.attention_mask.make_segment_ids (incl. quirk)."""
    pos = np.arange(max_seq_len)
    seg = np.where(pos < img_wp, 1, 0)
    seg += np.where((pos > img_wp) & (pos < img_wp + txt_wp), 2, 0)
    return seg.astype(np.int32)


class RecordCursor:
    """Record stream with a checkpointable ``(epoch, pos)`` position.

    Yields exactly the payload sequence the old ``_record_iter``
    generator did (shard-striding included); ``pos`` counts records
    *scanned* in the current epoch (pre-stride, i.e. the old loop's
    ``i``), so ``(epoch, pos)`` fully names a stream position.
    ``seek`` fast-forwards via TFRecord length-header hops
    (``tfrecord.skim_open``) -- payloads of skipped records are never
    read, which is what makes preemption-resume of the input stream
    cheap.
    """

    def __init__(self, patterns, shard_index, num_shards, seed, repeat):
        from mmt_tpu_torch.data import native

        self.patterns = patterns
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = seed
        self.repeat = repeat
        self._use_native = native.available()
        self.epoch = 0
        self.pos = 0
        self._files = None       # current epoch's resolved file list
        self._stride = False
        self._file_idx = 0
        self._file_start = 0     # pos at which the current file began
        self._rec_iter = None    # iterator over the current file

    def __iter__(self):
        return self

    def _load_epoch(self) -> None:
        self._files, self._stride = _glob_shard(
            self.patterns, self.shard_index, self.num_shards,
            seed=self.seed, epoch=self.epoch,
        )
        self.pos = 0
        self._file_idx = 0
        self._file_start = 0
        self._rec_iter = None

    def _open_file(self, path):
        if self._use_native:
            from mmt_tpu_torch.data import native

            return iter(native.iter_records(path))
        return iter(TFRecordReader(path))

    def __next__(self):
        while True:
            if self._files is None:
                self._load_epoch()
            if self._rec_iter is None:
                if self._file_idx >= len(self._files):
                    if not self.repeat:
                        raise StopIteration
                    self.epoch += 1
                    self._load_epoch()
                    continue
                self._rec_iter = self._open_file(self._files[self._file_idx])
            try:
                rec = next(self._rec_iter)
            except StopIteration:
                self._rec_iter = None
                self._file_idx += 1
                self._file_start = self.pos
                continue
            i = self.pos
            self.pos = i + 1
            if not self._stride or i % self.num_shards == self.shard_index:
                return rec

    def state(self):
        return (self.epoch, self.pos)

    def seek(self, epoch: int, pos: int) -> None:
        """Positions the cursor so the next record returned is the one
        the stream would have produced after scanning ``pos`` records of
        ``epoch``.  Forward seeks from the current position reuse the
        already-scanned prefix; backward seeks restart the epoch walk."""
        if (self._files is not None
                and (epoch, pos) == (self.epoch, self.pos)
                and self._rec_iter is not None):
            return
        behind = self._files is not None and (
            epoch < self.epoch
            or (epoch == self.epoch and pos < self._file_start)
        )
        if self._files is None or epoch != self.epoch or behind:
            self.epoch = epoch
            self._load_epoch()
        # Walk files from the current file, header-hopping `pos -
        # file_start` records into it; files that end earlier roll over.
        self._rec_iter = None
        while True:
            if self._file_idx >= len(self._files):
                # Position is the epoch end (pos == epoch size): the next
                # __next__ rolls into the next epoch (or stops).
                self.pos = pos
                return
            need = pos - self._file_start
            n, f = skim_open(self._files[self._file_idx], need)
            if f is None:  # file has only n (< need) records
                self._file_start += n
                self._file_idx += 1
                continue
            self._rec_iter = iter_open_records(f)
            self.pos = pos
            return


class _BaseLoader:
    def __init__(self, config: MmtDataConfig, tokenizer: Optional[BertTokenizer] = None):
        self.config = config
        if tokenizer is None:
            if not config.vocab_filename:
                raise ValueError("vocab_filename required (or pass a tokenizer)")
            # C++ fast path for ASCII text, transparent Python
            # fallback otherwise.
            tokenizer = NativeBertTokenizer(config.vocab_filename)
        self.tokenizer = tokenizer
        self.assembler = ExampleAssembler(config, tokenizer)

    def _record_iter(self, patterns, shard_index, num_shards, seed, repeat):
        return RecordCursor(patterns, shard_index, num_shards, seed, repeat)

    def _decode(self, payload: bytes, rng, is_training: bool) -> AssembledExample:
        cfg = self.config
        raw = parse_example(payload)
        extras = {}
        for key in ("index", "image_index", "text_index", "gt_image_index"):
            if key in raw:
                extras[key] = int(raw[key][0])
        if cfg.image_key_field in raw:
            v = raw[cfg.image_key_field][0]
            extras["image_key"] = v if isinstance(v, (int, float)) else bytes(v)

        image_bytes = None
        if cfg.image_data_field in raw and raw[cfg.image_data_field]:
            image_bytes = bytes(raw[cfg.image_data_field][0])

        text_fields = {}
        for field in self.assembler.field_to_special:
            if field in raw and raw[field]:
                v = raw[field][0]
                text_fields[field] = v.decode("utf-8", "replace") if isinstance(
                    v, (bytes, bytearray)
                ) else str(v)

        flip = bool(is_training and rng.random() > 0.5)
        rand_aug_fn = None
        if is_training and cfg.use_rand_aug and image_bytes is not None:
            if not hasattr(self, "_rand_augment"):
                from mmt_tpu_torch.data.rand_augment import RandAugment

                self._rand_augment = RandAugment(num_layers=1)
            rand_aug_fn = lambda im: self._rand_augment(im, rng)  # noqa: E731
        return self.assembler.assemble(
            image_bytes, text_fields or None, flip=flip, rand_aug_fn=rand_aug_fn,
            extras=extras, raw_u8=self.config.ship_raw_images,
        )


class MmtPretrainLoader(_BaseLoader):
    """MLM + MPP (+ ITM) pretraining batches (parity:
    ``src/data/pretrain_dataloader.py:74-224``)."""

    def __init__(self, config: MmtPretrainDataConfig, tokenizer=None):
        super().__init__(config, tokenizer)
        vocab = self.tokenizer.vocab
        self.cfg = config
        mask_token = (
            vocab["[PATCH_MASK]"] if config.use_patch_mask_token_id else vocab["[MASK]"]
        )
        self.mpp_spec = MaskingSpec(
            vocab_size=len(vocab),
            mask_token_id=mask_token,
            selection_rate=config.mpp_fraction_to_mask,
            max_selections=config.mpp_max_selections_per_seq,
        )
        self.mlm_spec = MaskingSpec(
            vocab_size=len(vocab),
            mask_token_id=vocab["[MASK]"],
            selection_rate=config.mlm_fraction_to_mask,
            max_selections=min(config.mlm_max_selections_per_seq, config.max_seq_len),
        )

    def _selected_raw_patches(self, u8_image, shifted):
        """<float32>[m, 3p^2] raw patches of the SELECTED positions only,
        sliced straight out of the uint8 image (``ship_raw_images``: the full
        unnormalized patch tensor is never made on the host; the /255
        rounding is the assembler's)."""
        p = self.cfg.patch_size
        g = self.cfg.image_size // p
        view = u8_image.reshape(g, p, g, p, 3).transpose(0, 2, 1, 3, 4)
        sel = view[shifted // g, shifted % g]  # [m, p, p, 3] (copies m patches)
        return np.true_divide(sel, 255, dtype=np.float32).reshape(len(shifted), -1)

    def _mask_example(self, ex: AssembledExample, rng) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        n = cfg.num_patches
        raw_mode = cfg.ship_raw_images and "raw_image" in ex.extras

        # MPP over [CLS] [PATCH] p1..pN (only patches selectable), drawn
        # before MLM from the same rng.
        patch_items = np.asarray(ex.patch_token_ids, np.int32)  # 1 token/item
        selectable = np.zeros((len(patch_items),), bool)
        selectable[2:] = True
        mpp = mask_items(patch_items, self.mpp_spec, rng, selectable)

        if len(mpp.positions):
            shifted = mpp.positions - 2
            raw_patches = (
                self._selected_raw_patches(ex.extras["raw_image"], shifted)
                if raw_mode
                else ex.unnormalized_patch_embeddings[shifted]
            )
            mpp_label_ids = make_mpp_label_ids(
                raw_patches, cfg.patch_size, cfg.input_channels, cfg.max_pixel_val,
                cfg.output_channel_bits)
        else:
            mpp_label_ids = np.zeros((0,), np.int32)
        # Zero the features of patches whose token became the mask token:
        # here on the host, or, with raw images, in the encoder from the
        # shipped mask.
        masked_slots = mpp.token_ids[2:] == self.mpp_spec.mask_token_id
        if raw_mode:
            patch_fields = {
                "images": ex.extras["raw_image"],
                "patch_mask": masked_slots.astype(np.float32),
            }
        else:
            patch_embeddings = ex.patch_embeddings.copy()
            patch_embeddings[masked_slots] = 0.0
            patch_fields = {"patch_embeddings": patch_embeddings}

        # MLM, whole words over the text.
        mlm = mask_items(ex.text_token_words, self.mlm_spec, rng, ex.text_selectable)
        mlm_positions = mlm.positions + 2 + n

        m = cfg.mpp_max_selections_per_seq
        l = min(cfg.mlm_max_selections_per_seq, cfg.max_seq_len)  # noqa: E741
        text_ids = pad_1d(mlm.token_ids, self.assembler.max_remaining_seq_len)
        return {
            "patch_token_ids": mpp.token_ids,
            **patch_fields,
            "num_image_wordpieces": np.int32(ex.num_image_wordpieces),
            "text_token_ids": text_ids,
            "num_text_wordpieces": np.int32(ex.num_text_wordpieces),
            "mpp_positions": pad_1d(mpp.positions, m),
            "mpp_label_ids": pad_1d(mpp_label_ids, m),
            "mpp_label_weights": pad_1d(mpp.label_weights, m),
            "mlm_positions": pad_1d(mlm_positions, l),
            "mlm_label_ids": pad_1d(mlm.label_ids, l),
            "mlm_label_weights": pad_1d(mlm.label_weights, l),
        }

    def load(
        self, shard_index: int = 0, num_shards: int = 1, batch_size: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        return iter(self.stream(shard_index, num_shards, batch_size))

    def stream(
        self, shard_index: int = 0, num_shards: int = 1, batch_size: Optional[int] = None
    ) -> "TrainStream":
        """The batch iterator as a checkpointable ``TrainStream``."""
        cfg = self.cfg
        batch_size = batch_size or cfg.global_batch_size
        do_itm = "itm" in (cfg.tasks or "")
        # ITM doubles the batch (ratio 1): collect half per matching call.
        # Post-match shuffle: the matched examples pass through a shuffle
        # buffer before rebatching, so every batch (and micro-batch) mixes
        # positives and negatives (src/data/pretrain_dataloader.py:213-215).
        return TrainStream(
            self, shard_index, num_shards, batch_size=batch_size,
            collect=batch_size // 2 if do_itm else batch_size,
            shuffle_size=cfg.shuffle_buffer_size,
            shuffled=do_itm and cfg.is_training,
        )

    def _collect_batch(self, records, rng, collect) -> Dict[str, np.ndarray]:
        """Consumes records until one matched batch is assembled."""
        cfg = self.cfg
        do_itm = "itm" in (cfg.tasks or "")
        examples, keys = [], []
        while len(examples) < collect:
            ex = self._decode(next(records), rng, cfg.is_training)
            # Short-text filter (src/data/pretrain_dataloader.py:152-163).
            if ex.num_text_wordpieces < cfg.min_text_wordpieces:
                continue
            examples.append(self._mask_example(ex, rng))
            keys.append(ex.extras.get("image_key", len(keys)))
        return self._finalize_batch(examples, keys, do_itm)

    def _finalize_batch(self, examples, keys, do_itm) -> Dict[str, np.ndarray]:
        batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
        if do_itm:
            batch = make_matching_features(
                batch, keys, negative_positive_ratio=1, min_shift=self.cfg.min_shift)
        return self._to_model_batch(batch)

    def _to_model_batch(self, batch) -> Dict[str, np.ndarray]:
        s = self.cfg.max_seq_len
        b = batch["patch_token_ids"].shape[0]
        word_ids = np.zeros((b, s), np.int32)
        joint = np.concatenate(
            [batch.pop("patch_token_ids"), batch.pop("text_token_ids")], axis=1
        )[:, :s]
        word_ids[:, : joint.shape[1]] = joint
        img_wp = batch.pop("num_image_wordpieces")
        txt_wp = batch.pop("num_text_wordpieces")
        batch["word_ids"] = word_ids
        batch["segment_ids"] = np.stack(
            [_segment_ids(s, int(i), int(t)) for i, t in zip(img_wp, txt_wp)])
        batch["lengths"] = (img_wp + txt_wp).astype(np.int32)
        return batch


class MmtClassificationLoader(_BaseLoader):
    """ITM classification batches (parity: classification_dataloader.py)."""

    def __init__(self, config: MmtClassificationDataConfig, tokenizer=None):
        super().__init__(config, tokenizer)
        self.cfg = config

    def load(
        self, shard_index: int = 0, num_shards: int = 1, batch_size: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        return iter(self.stream(shard_index, num_shards, batch_size))

    def stream(
        self, shard_index: int = 0, num_shards: int = 1, batch_size: Optional[int] = None
    ) -> "TrainStream":
        """The batch iterator as a checkpointable ``TrainStream``."""
        cfg = self.cfg
        batch_size = batch_size or cfg.global_batch_size
        ratio = cfg.negative_positive_ratio
        # Post-match shuffle before rebatching, mixing positives and
        # negatives per batch (src/data/classification_dataloader.py:180).
        return TrainStream(
            self, shard_index, num_shards, batch_size=batch_size,
            collect=max(1, batch_size // (ratio + 1)),
            shuffle_size=cfg.shuffle_buffer_size,
            shuffled=cfg.is_training,
        )

    def _collect_batch(self, records, rng, collect) -> Dict[str, np.ndarray]:
        examples, keys = [], []
        while len(examples) < collect:
            try:
                payload = next(records)
            except StopIteration:
                # The end of a split read once (eval): its last matched
                # batch is partial, kept unless drop_remainder.
                if not examples or self.cfg.drop_remainder:
                    raise
                break
            ex = self._decode(payload, rng, self.cfg.is_training)
            examples.append(self._features(ex))
            keys.append(ex.extras.get("image_key", len(keys)))
        return self._finalize(examples, keys)

    def _features(self, ex: AssembledExample) -> Dict[str, np.ndarray]:
        text_ids = pad_1d(
            self.assembler.flat_text_ids(ex.text_token_words),
            self.assembler.max_remaining_seq_len,
        )
        feats = {
            "patch_token_ids": ex.patch_token_ids,
            "num_image_wordpieces": np.int32(ex.num_image_wordpieces),
            "text_token_ids": text_ids,
            "num_text_wordpieces": np.int32(ex.num_text_wordpieces),
        }
        if "raw_image" in ex.extras:  # ship_raw_images
            feats["images"] = ex.extras["raw_image"]
        else:
            feats["patch_embeddings"] = ex.patch_embeddings
        return feats

    def _finalize(self, examples, keys) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
        batch = make_matching_features(
            batch,
            keys,
            negative_positive_ratio=cfg.negative_positive_ratio,
            min_shift=cfg.min_shift,
        )
        s = cfg.max_seq_len
        b = batch["patch_token_ids"].shape[0]
        word_ids = np.zeros((b, s), np.int32)
        joint = np.concatenate(
            [batch.pop("patch_token_ids"), batch.pop("text_token_ids")], axis=1
        )[:, :s]
        word_ids[:, : joint.shape[1]] = joint
        img_wp = batch.pop("num_image_wordpieces")
        txt_wp = batch.pop("num_text_wordpieces")
        out = {
            "word_ids": word_ids,
            "segment_ids": np.stack(
                [_segment_ids(s, int(i), int(t)) for i, t in zip(img_wp, txt_wp)]
            ),
            "lengths": (img_wp + txt_wp).astype(np.int32),
            "label_ids": batch["itm_label_ids"],
            "label_weights": batch["itm_label_weights"],
            "pos_weights": np.where(
                batch["itm_label_ids"] > 0, self.cfg.pos_weight, 1.0
            ).astype(np.float32),
        }
        if "images" in batch:
            out["images"] = batch["images"]
        else:
            out["patch_embeddings"] = batch["patch_embeddings"]
        return out


class MmtRetrievalLoader(_BaseLoader):
    """Retrieval scoring batches (parity: retrieval_dataloader.py).

    Either paired image+text records, or the on-the-fly cross product of
    separate image and text record files.  Emits static-shaped batches
    with a ``valid`` mask covering the final partial batch.
    """

    def __init__(self, config: MmtRetrievalDataConfig, tokenizer=None):
        super().__init__(config, tokenizer)
        self.cfg = config

    def _example_iter(self, shard_index, num_shards, rng):
        # ship_raw_images: _decode attaches the uint8 image to
        # ``ex.extras["raw_image"]`` (and skips host patch extraction
        # entirely); the cross-product below shares one decoded image
        # example across its ~100 texts.
        cfg = self.cfg
        if cfg.input_path:
            for payload in self._record_iter(
                cfg.input_path, 0, 1, None, repeat=False
            ):
                yield self._decode(payload, rng, False)
            return
        # Cross product: image-major outer loop (parity with the reference's
        # nested interleave, retrieval_dataloader.py:139-195).  Decoded
        # text features are cached up to ``max_cached_text_examples``;
        # larger pools (WIT-scale) stream the tail from disk per image,
        # bounding host RAM at the cost of re-decoding.
        image_files, _ = _glob_shard(cfg.image_input_path, 0, 1)
        text_files, _ = _glob_shard(cfg.text_input_path, 0, 1)
        cap = cfg.max_cached_text_examples
        texts = []
        overflow = False
        for tf_path in text_files:
            for payload in TFRecordReader(tf_path):
                if len(texts) < cap:
                    texts.append(self._decode(payload, rng, False))
                else:
                    overflow = True
                    break
            if overflow:
                break

        def text_iter():
            yield from texts
            if overflow:
                seen = 0
                for tf_path in text_files:
                    for payload in TFRecordReader(tf_path):
                        seen += 1
                        if seen > len(texts):
                            yield self._decode(payload, rng, False)

        for img_path in image_files:
            for payload in TFRecordReader(img_path):
                img = self._decode(payload, rng, False)
                for txt in text_iter():
                    yield AssembledExample(
                        patch_token_ids=img.patch_token_ids,
                        text_token_words=txt.text_token_words,
                        patch_embeddings=img.patch_embeddings,
                        unnormalized_patch_embeddings=None,
                        num_image_wordpieces=img.num_image_wordpieces,
                        num_text_wordpieces=txt.num_text_wordpieces,
                        text_selectable=txt.text_selectable,
                        extras={**txt.extras, **img.extras},
                    )

    def load(
        self, shard_index: int = 0, num_shards: int = 1, batch_size: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        batch_size = batch_size or cfg.global_batch_size
        rng = np.random.default_rng(cfg.seed)
        # Shard AFTER enumeration (retrieval_dataloader.py:204-207).
        it = itertools.islice(
            self._example_iter(shard_index, num_shards, rng), shard_index, None, num_shards
        )
        batch: List[AssembledExample] = []
        for ex in it:
            batch.append(ex)
            if len(batch) == batch_size:
                yield self._finalize(batch, batch_size)
                batch = []
        if batch and not cfg.drop_remainder:
            yield self._finalize(batch, batch_size)

    def _finalize(self, examples, batch_size) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        s = cfg.max_seq_len
        b = len(examples)
        word_ids = np.zeros((batch_size, s), np.int32)
        seg = np.zeros((batch_size, s), np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        raw_mode = cfg.ship_raw_images
        if raw_mode:
            size = cfg.image_size
            images = np.zeros((batch_size, size, size, 3), np.uint8)
        else:
            patches = np.zeros(
                (batch_size,) + examples[0].patch_embeddings.shape, np.float32
            )
        image_index = np.full((batch_size,), -1, np.int64)
        text_index = np.full((batch_size,), -1, np.int64)
        gt_image_index = np.full((batch_size,), -1, np.int64)
        for i, ex in enumerate(examples):
            text_ids = self.assembler.flat_text_ids(ex.text_token_words)
            word_ids[i] = self.assembler.finalize_word_ids(ex.patch_token_ids, text_ids)
            seg[i] = _segment_ids(s, ex.num_image_wordpieces, ex.num_text_wordpieces)
            lengths[i] = ex.num_image_wordpieces + ex.num_text_wordpieces
            if raw_mode:
                if "raw_image" in ex.extras:
                    images[i] = ex.extras["raw_image"]
            else:
                patches[i] = ex.patch_embeddings
            image_index[i] = ex.extras.get("image_index", -1)
            text_index[i] = ex.extras.get("text_index", -1)
            gt_image_index[i] = ex.extras.get("gt_image_index", -1)

        label = (image_index == gt_image_index).astype(np.int32)
        weights = 1.0 + label.astype(np.float32) * (cfg.pos_weight - 1)
        valid = (np.arange(batch_size) < b).astype(np.int32)
        out = {
            "word_ids": word_ids,
            "segment_ids": seg,
            "lengths": np.maximum(lengths, 1),
            "label_ids": label,
            "label_weights": weights * valid,
            "image_index": image_index,
            "text_index": text_index,
            "gt_image_index": gt_image_index,
            "valid": valid,
        }
        if raw_mode:
            out["images"] = images
        else:
            out["patch_embeddings"] = patches
        return out


class _Item:
    """A row in flight between unbatching and rebatching, tagged with the
    matched batch it came from (for provenance-based stream snapshots)."""

    __slots__ = ("row", "bid", "idx")

    def __init__(self, row, bid, idx):
        self.row = row
        self.bid = bid
        self.idx = idx


class TrainStream:
    """Checkpointable training batch iterator.

    Yields accumulate -> finalize -> unbatch -> shuffle buffer -> rebatch,
    one shared rng in one draw order, and gives ``state()`` /
    ``restore()`` so that a resumed run continues the input stream
    exactly where it left off instead of replaying epoch 0.

    Snapshots are provenance-based so they stay small (no example
    payloads): every matched batch records the (epoch, pos, rng-state) it
    was produced from; ``restore`` replays only the matched batches with
    rows still alive in the shuffle buffer / pending queue, walking the
    record files once in position order (skipped spans are header-hops,
    ``RecordCursor.seek``, so only ~shuffle_buffer_size examples are
    decoded again).
    """

    def __init__(self, loader, shard_index: int, num_shards: int, *,
                 batch_size: int, collect: int, shuffle_size: int,
                 shuffled: bool):
        cfg = loader.cfg
        self._loader = loader
        self._cursor_args = (cfg.input_path, shard_index, num_shards,
                             cfg.seed, cfg.is_training)
        self._cursor = RecordCursor(*self._cursor_args)
        self._rng = np.random.default_rng(cfg.seed + shard_index)
        self._batch_size = batch_size
        self._collect = collect
        self._shuffle_size = shuffle_size
        self._shuffled = shuffled
        self._pending: collections.deque = collections.deque()
        self._shufbuf: Optional[List[_Item]] = None
        self._prov: Dict[int, tuple] = {}
        self._refs: Dict[int, int] = {}
        self._compact_at: Dict[int, int] = {}
        self._next_bid = 0

    def __iter__(self):
        return self

    def _next_matched(self) -> Dict[str, np.ndarray]:
        prov = (self._cursor.epoch, self._cursor.pos,
                copy.deepcopy(self._rng.bit_generator.state))
        batch = self._loader._collect_batch(self._cursor, self._rng,
                                            self._collect)
        if self._shuffled:
            bid = self._next_bid
            self._next_bid += 1
            rows = list(_unbatch(batch))
            self._prov[bid] = prov
            self._refs[bid] = len(rows)
            self._compact_at[bid] = len(rows) // _COMPACT_SHARE
            self._pending.extend(
                _Item(row, bid, i) for i, row in enumerate(rows))
        return batch

    def _pull(self) -> _Item:
        if not self._pending:
            self._next_matched()
        return self._pending.popleft()

    def _shuffle_next(self) -> _Item:
        if self._shuffle_size <= 0:
            return self._pull()
        if self._shufbuf is None:
            self._shufbuf = [self._pull() for _ in range(self._shuffle_size)]
        item = self._pull()
        i = int(self._rng.integers(len(self._shufbuf)))
        out = self._shufbuf[i]
        self._shufbuf[i] = item
        return out

    def _release(self, item: _Item) -> None:
        bid = item.bid
        self._refs[bid] -= 1
        if not self._refs[bid]:
            del self._refs[bid]
            del self._prov[bid]
            self._compact_at.pop(bid, None)
        elif self._refs[bid] <= self._compact_at.get(bid, -1):
            self._copy_rows(bid)

    def _copy_rows(self, bid: int) -> None:
        """Copies the waiting rows of matched batch ``bid`` out of it, so
        that it is freed (same contents)."""
        del self._compact_at[bid]
        for it in itertools.chain(self._shufbuf or (), self._pending):
            if it.bid == bid:
                it.row = {k: v.copy() for k, v in it.row.items()}

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._shuffled:
            # Direct emission (eval): one matched batch per output batch;
            # the record cursor's StopIteration ends the stream.
            return self._next_matched()
        items = [self._shuffle_next() for _ in range(self._batch_size)]
        batch = {k: np.stack([it.row[k] for it in items])
                 for k in items[0].row}
        for it in items:
            self._release(it)
        return batch

    # ------------------------------------------------- snapshot/restore

    def state(self) -> dict:
        """Snapshot at a batch boundary; pickle-able, payload-free."""
        st = {
            "version": 1,
            "shuffled": self._shuffled,
            "cursor": self._cursor.state(),
            "rng": copy.deepcopy(self._rng.bit_generator.state),
        }
        if self._shuffled:
            st["prov"] = dict(self._prov)
            st["shufbuf"] = (None if self._shufbuf is None else
                             [(it.bid, it.idx) for it in self._shufbuf])
            st["pending"] = [(it.bid, it.idx) for it in self._pending]
            st["next_bid"] = self._next_bid
        return st

    def restore(self, st: dict) -> None:
        if st.get("version") != 1:
            raise ValueError(f"unknown stream-state version: {st.get('version')}")
        if bool(st["shuffled"]) != self._shuffled:
            raise ValueError("stream state does not match this loader config")
        self._rng.bit_generator.state = copy.deepcopy(st["rng"])
        if not self._shuffled:
            self._cursor.seek(*st["cursor"])
            return
        # Replay the live matched batches in stream order: one forward
        # walk, header-hopping the gaps between them.
        rows_of: Dict[int, List[dict]] = {}
        tmp_rng = np.random.default_rng()
        for bid, (epoch, pos, rstate) in sorted(
                st["prov"].items(), key=lambda kv: (kv[1][0], kv[1][1])):
            self._cursor.seek(epoch, pos)
            tmp_rng.bit_generator.state = copy.deepcopy(rstate)
            batch = self._loader._collect_batch(self._cursor, tmp_rng,
                                                self._collect)
            rows_of[bid] = list(_unbatch(batch))

        def make(ref):
            bid, idx = ref
            return _Item(rows_of[bid][idx], bid, idx)

        self._shufbuf = (None if st["shufbuf"] is None else
                         [make(r) for r in st["shufbuf"]])
        self._pending = collections.deque(make(r) for r in st["pending"])
        self._prov = dict(st["prov"])
        refs = collections.Counter(it.bid for it in (self._shufbuf or []))
        refs.update(it.bid for it in self._pending)
        self._refs = dict(refs)
        self._compact_at = {bid: len(rows) // _COMPACT_SHARE for bid, rows in rows_of.items()}
        for bid, left in self._refs.items():
            if left <= self._compact_at[bid]:
                self._copy_rows(bid)
        self._next_bid = st["next_bid"]
        self._cursor.seek(*st["cursor"])


class ResumablePrefixed:
    """Lets a caller pre-pull the first batch from a resumable stream and
    still hand the loop a correct state()/restore() surface: while the
    pre-pulled batch is queued, ``state()`` reports the stream position
    from *before* it was pulled, and ``restore()`` drops the stale
    queue."""

    def __init__(self, stream: TrainStream):
        self._stream = stream
        self._st0 = stream.state()
        self._prefix: List[Dict[str, np.ndarray]] = []

    def prime(self) -> Dict[str, np.ndarray]:
        first = next(self._stream)
        self._prefix = [first]
        return first

    def __iter__(self):
        return self

    def __next__(self):
        if self._prefix:
            return self._prefix.pop(0)
        return next(self._stream)

    def state(self) -> dict:
        return self._st0 if self._prefix else self._stream.state()

    def restore(self, st: dict) -> None:
        self._prefix = []
        self._stream.restore(st)
