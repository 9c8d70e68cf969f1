"""Example assembly: raw record -> model features (host-side numpy).

The port's own copy of ``mmt_tpu/data/assembly.py``: the same functions on
numpy arrays, over the port's tokenizer, trimmer and patch functions.

Re-provides the reference's decode path (``src/data/data_utils.py``
``get_decode_fn``/``get_word_ids_fn``: image decode -> normalize (by
MEAN, faithfully) -> resize -> patches; per-field tokenize -> round-robin
trim -> special-token interleave -> [SEP]; patch unused-token ids;
sequence packing) as plain functions over numpy arrays.

No [S, S] side inputs are built here: the model derives them on the
device from ``lengths`` (and the static id map).
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmt_tpu_torch.configs.data import MmtDataConfig
from mmt_tpu_torch.features.patches import extract_patches, normalize_image
from mmt_tpu_torch.text.trimmer import round_robin_trim
from mmt_tpu_torch.text.wordpiece import BertTokenizer

PATCH_START_UNUSED_INDEX = 104  # unused99 (src/data/data_utils.py:31)


@dataclasses.dataclass
class AssembledExample:
    """Host features for one example (pre-masking, pre-batching)."""

    patch_token_ids: np.ndarray  # <int32>[2 + N]: [CLS] [PATCH] p1..pN
    text_token_words: List[np.ndarray]  # word-aligned wordpiece ids incl specials
    patch_embeddings: np.ndarray  # <float32>[N, 3p^2] normalized
    unnormalized_patch_embeddings: Optional[np.ndarray]  # for MPP labels
    num_image_wordpieces: int
    num_text_wordpieces: int
    text_selectable: Optional[np.ndarray] = None  # per word, False for specials
    extras: Optional[Dict] = None  # passthrough (indices, keys)


class ExampleAssembler:
    def __init__(self, config: MmtDataConfig, tokenizer: BertTokenizer):
        self.config = config
        self.tokenizer = tokenizer
        vocab = tokenizer.vocab
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.patch_id = vocab["[PATCH]"]
        self.mask_id = vocab["[MASK]"]
        self.vocab_size = len(vocab)

        self.field_to_special = {
            k: vocab[v]
            for k, v in json.loads(config.text_special_token_field_dict).items()
        }
        n = config.num_patches
        # Patch slots use distinct unused vocab tokens starting at
        # [unused99] -- index 104 in the standard BERT vocab (the
        # reference hardcodes 104; src/data/data_utils.py:31,108-115).
        # Deriving it from the vocab keeps parity there and stays
        # in-range for custom vocabs.
        patch_start = vocab.get("[unused99]", PATCH_START_UNUSED_INDEX)
        if n > 895:
            raise ValueError(f"too many patches ({n}) for the unused-token range")
        if patch_start + n > len(vocab):
            raise ValueError(
                f"vocab too small: patches need ids [{patch_start}, "
                f"{patch_start + n}) but vocab has {len(vocab)} entries"
            )
        self.patch_ids = np.arange(patch_start, patch_start + n, dtype=np.int32)
        # Budget: max_seq_len - #special_tokens - [SEP] - [CLS] - [PATCH] - N
        # (src/data/data_utils.py:117-121).
        self.max_text_wordpieces = (
            config.max_seq_len - len(self.field_to_special) - 1 - 2 - n
        )
        self.max_remaining_seq_len = config.max_seq_len - n - 2

    # ------------------------------------------------------------- image

    def decode_image(self, image_bytes: bytes) -> np.ndarray:
        """JPEG/PNG bytes -> float32 [H, W, 3] in [0, 1].

        JPEG goes through the native libjpeg-turbo decoder when the
        library is built and loads; PNG and anything the native decoder
        declines fall back to PIL.
        """
        from mmt_tpu_torch.data import native

        rgb = native.decode_jpeg(image_bytes)
        if rgb is None:
            from PIL import Image

            im = Image.open(io.BytesIO(image_bytes)).convert("RGB")
            rgb = np.asarray(im)
        # One-pass uint8 -> [0, 1] float32 (identical rounding to
        # astype-then-divide, without the intermediate copy).
        return np.true_divide(rgb, 255, dtype=np.float32)

    def raw_image_u8(self, image_bytes: bytes, flip: bool = False) -> np.ndarray:
        """uint8 [size, size, 3] for the device-side patch path
        (``ship_raw_images``).  Sources must already be square at
        ``image_size``: a host resize here would reorder the faithful
        normalize-then-resize float sequence."""
        from mmt_tpu_torch.data import native

        rgb = native.decode_jpeg(image_bytes)
        if rgb is None:
            from PIL import Image

            rgb = np.asarray(
                Image.open(io.BytesIO(image_bytes)).convert("RGB")
            )
        size = self.config.image_size
        if rgb.shape[:2] != (size, size):
            raise ValueError(
                f"ship_raw_images requires {size}x{size} sources, got "
                f"{rgb.shape[:2]} (pre-resize the dataset or disable the flag)"
            )
        return np.ascontiguousarray(rgb[:, ::-1]) if flip else rgb

    def resize(self, image: np.ndarray) -> np.ndarray:
        """Bilinear resize to (image_size, image_size) matching
        tf.image.resize defaults (half-pixel centers, no antialias)."""
        size = self.config.image_size
        h, w = image.shape[:2]
        if (h, w) == (size, size):
            return image
        ys = (np.arange(size) + 0.5) * h / size - 0.5
        xs = (np.arange(size) + 0.5) * w / size - 0.5
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
        wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
        top = image[y0][:, x0] * (1 - wx) + image[y0][:, x1] * wx
        bot = image[y1][:, x0] * (1 - wx) + image[y1][:, x1] * wx
        return (top * (1 - wy) + bot * wy).astype(np.float32)

    def image_features(
        self, image_bytes: bytes, flip: bool = False, rand_aug_fn=None
    ) -> Dict[str, np.ndarray]:
        im = self.decode_image(image_bytes)
        if rand_aug_fn is not None:
            im = rand_aug_fn(im)
        p = self.config.patch_size
        size = self.config.image_size
        if im.shape[0] == size and im.shape[1] == size:
            # No resize needed: per-pixel normalization commutes exactly
            # with flip/patch rearrangement, so extract once and
            # normalize the patch view -- one big copy instead of three
            # (hot host-pipeline path; values bit-identical).
            raw = im[:, ::-1] if flip else im
            raw_p = extract_patches(raw, p).astype(np.float32, copy=False)
            chan = raw_p.reshape(raw_p.shape[0], p * p, im.shape[2])
            norm_p = normalize_image(chan).reshape(raw_p.shape)
            return {
                "patch_embeddings": norm_p,
                "unnormalized_patch_embeddings": raw_p,
            }
        # Faithful order: normalize (by MEAN) THEN resize; raw copy resized
        # separately (src/data/data_utils.py:204-207).
        norm = self.resize(normalize_image(im))
        raw = self.resize(im)
        if flip:
            norm = norm[:, ::-1]
            raw = raw[:, ::-1]
        return {
            "patch_embeddings": extract_patches(norm, p).astype(np.float32),
            "unnormalized_patch_embeddings": extract_patches(raw, p).astype(np.float32),
        }

    # -------------------------------------------------------------- text

    def text_features(self, fields: Dict[str, str]):
        """Tokenize + trim + interleave special tokens; returns
        (word-aligned list, selectable mask)."""
        tokenized = [
            self.tokenizer.tokenize(fields.get(k, "") or "")
            for k in self.field_to_special
        ]
        trimmed = round_robin_trim(tokenized, self.max_text_wordpieces)

        words: List[np.ndarray] = []
        selectable: List[bool] = []
        for special_id, field_words in zip(self.field_to_special.values(), trimmed):
            words.append(np.array([special_id], np.int32))
            selectable.append(False)
            for w in field_words:
                words.append(np.asarray(w, np.int32))
                selectable.append(True)
        words.append(np.array([self.sep_id], np.int32))
        selectable.append(False)
        return words, np.asarray(selectable, bool)

    # ----------------------------------------------------------- assemble

    def assemble(
        self,
        image_bytes: Optional[bytes],
        text_fields: Optional[Dict[str, str]],
        flip: bool = False,
        rand_aug_fn=None,
        extras: Optional[Dict] = None,
        raw_u8: bool = False,
    ) -> AssembledExample:
        n = self.config.num_patches
        patch_token_ids = np.concatenate(
            [[self.cls_id, self.patch_id], self.patch_ids]
        ).astype(np.int32)

        if image_bytes is not None and raw_u8:
            # Device-side patch path (ship_raw_images): carry the uint8
            # image; /255 + MEAN-normalize + patch extraction run in the
            # encoder, on the device.  No host patch work at all.
            if rand_aug_fn is not None:
                raise ValueError(
                    "ship_raw_images is incompatible with use_rand_aug "
                    "(RandAugment runs on host float images)"
                )
            extras = dict(extras or {})
            extras["raw_image"] = self.raw_image_u8(image_bytes, flip)
            img = {"patch_embeddings": None, "unnormalized_patch_embeddings": None}
        elif image_bytes is not None:
            img = self.image_features(image_bytes, flip, rand_aug_fn)
        else:
            img = {
                "patch_embeddings": np.zeros(
                    (n, 3 * self.config.patch_size**2), np.float32
                ),
                "unnormalized_patch_embeddings": None,
            }
        if text_fields is not None:
            words, selectable = self.text_features(text_fields)
            num_text = int(sum(len(w) for w in words))
        else:
            words, selectable, num_text = [], np.zeros((0,), bool), 0

        return AssembledExample(
            patch_token_ids=patch_token_ids,
            text_token_words=words,
            patch_embeddings=img["patch_embeddings"],
            unnormalized_patch_embeddings=img["unnormalized_patch_embeddings"],
            num_image_wordpieces=2 + n,
            num_text_wordpieces=num_text,
            text_selectable=selectable,
            extras=extras or {},
        )

    def flat_text_ids(self, words: Sequence[np.ndarray]) -> np.ndarray:
        if not len(words):
            return np.zeros((0,), np.int32)
        return np.concatenate(words).astype(np.int32)

    def finalize_word_ids(
        self, patch_token_ids: np.ndarray, text_ids: np.ndarray
    ) -> np.ndarray:
        """[CLS][PATCH]p1..pN <text...> padded to max_seq_len."""
        s = self.config.max_seq_len
        out = np.zeros((s,), np.int32)
        joint = np.concatenate([patch_token_ids, text_ids])[:s]
        out[: len(joint)] = joint
        return out
