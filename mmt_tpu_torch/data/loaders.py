"""Task dataloaders: the retrieval loader.

The port's own copy of the retrieval side of ``mmt_tpu/data/loaders.py``
(``_glob_shard``, ``_segment_ids``, ``RecordCursor``, ``_BaseLoader``,
``MmtRetrievalLoader``): host-side numpy pipelines (glob -> shard ->
decode -> batch) yielding dicts of numpy arrays that the prediction loop
moves to its device.

* No [S, S] side inputs: batches carry ``lengths`` (+ host-cheap
  ``segment_ids``); the model derives masks and ids on the device.
* Retrieval's ``drop_remainder=False`` final partial batch is padded to
  the batch size with a ``valid`` mask (the host filters on it), so that
  every batch has one shape.

Not ported yet: ``MmtPretrainLoader``, ``MmtClassificationLoader``,
``TrainStream`` and RandAugment (``use_rand_aug`` raises in training).
"""

from __future__ import annotations

import glob as globlib
import itertools
from typing import Dict, Iterator, List, Optional

import numpy as np

from mmt_tpu_torch.configs.data import MmtDataConfig, MmtRetrievalDataConfig
from mmt_tpu_torch.data.assembly import AssembledExample, ExampleAssembler
from mmt_tpu_torch.data.tfrecord import (
    TFRecordReader,
    iter_open_records,
    parse_example,
    skim_open,
)
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
        if is_training and cfg.use_rand_aug and image_bytes is not None:
            raise NotImplementedError("use_rand_aug: RandAugment is not ported yet")
        return self.assembler.assemble(
            image_bytes, text_fields or None, flip=flip, rand_aug_fn=None,
            extras=extras, raw_u8=self.config.ship_raw_images,
        )


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
