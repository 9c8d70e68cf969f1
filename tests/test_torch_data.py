"""The port's host data path against the JAX package's, on the same inputs.

Records, vocabularies, strings and images are made from numpy seeds; each
goes through ``mmt_tpu`` and through ``mmt_tpu_torch`` and the results
must be equal (host code: exact, unless a tolerance is stated).
"""

import io

import numpy as np
import pytest
import torch

from mmt_tpu.configs.data import MmtRetrievalDataConfig as JaxRetrievalConfig
from mmt_tpu.data import tfrecord as jax_tfrecord
from mmt_tpu.data.assembly import ExampleAssembler as JaxAssembler
from mmt_tpu.data.loaders import MmtRetrievalLoader as JaxRetrievalLoader
from mmt_tpu.data.loaders import _glob_shard as jax_glob_shard
from mmt_tpu.features import attention_mask as jax_attention_mask
from mmt_tpu.features import patches as jax_patches
from mmt_tpu.text import BertTokenizer as JaxTokenizer
from mmt_tpu.text import round_robin_trim as jax_round_robin_trim
from mmt_tpu_torch.configs.data import MmtRetrievalDataConfig
from mmt_tpu_torch.data import tfrecord
from mmt_tpu_torch.data.assembly import ExampleAssembler
from mmt_tpu_torch.data.loaders import MmtRetrievalLoader, RecordCursor, _glob_shard, _segment_ids
from mmt_tpu_torch.features import patches
from mmt_tpu_torch.features.attention_mask import make_segment_ids
from mmt_tpu_torch.text import BertTokenizer, round_robin_trim
from mmt_tpu_torch.text.native import NativeBertTokenizer

WORDS = ["red", "blue", "shirt", "dress", "cotton", "wool", "style", "fashion"]
VOCAB = (
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[ATT]", "[REF]", "[PATCH]"]
    + [f"[unused{i}]" for i in range(99, 120)]
    + WORDS
)
TEXT_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[ATT]", "[REF]", "[PATCH]",
    "the", "quick", "brown", "fox", "jump", "##ed", "##s", "over", "lazy",
    "dog", "un", "##aff", "##able", "hello", "world", "!", ",", "a",
    "[unused99]", "[unused100]",
    "multi", "##modal", "transform", "##er", "##res", "encode",
    "image", "text", "and", "caps", "12", "##34", "56", ".", "78",
    "9", "##,", "000", "naive", "cafe", "resume", "&", "...",
    "spacing", "weird", "s", "##pace",
]
STRINGS = [
    "The quick brown fox jumped!",
    "zzz [CLS] [unused99] unaffable",
    "The quick brown fox jumps over the lazy dog!",
    "Multimodal transformers encode images & text, efficiently.",
    "weird   spacing\tand CAPS and punctuation...",
    "naïve café résumé",
    "1234 56.78 9,000",
    "unaffable hello, world!",
    "",
]


def _vocab_file(tmp_path, vocab=VOCAB, name="vocab.txt"):
    p = tmp_path / name
    p.write_text("\n".join(vocab) + "\n")
    return str(p)


def _png(rng, height=32, width=32):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (height, width, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _write_records(module, path, n, rng, image_only=False, text_only=False):
    with module.TFRecordWriter(path) as w:
        for i in range(n):
            feats = {}
            if not text_only:
                feats["image_data"] = [_png(rng)]
                feats["image_key"] = [f"img{i}".encode()]
                feats["image_index"] = [i]
            if not image_only:
                feats["caption_attribution_description"] = [
                    " ".join(rng.choice(WORDS, size=int(rng.integers(3, 30)))).encode()]
                feats["caption_reference_description"] = [
                    " ".join(rng.choice(WORDS, size=4)).encode()]
                feats["text_index"] = [i]
                feats["gt_image_index"] = [i // 2 if text_only else i]
            w.write(module.build_example(feats))
    return path


# ------------------------------------------------------------------ tfrecord


@pytest.mark.parametrize("writer,reader", [
    (tfrecord, tfrecord), (tfrecord, jax_tfrecord), (jax_tfrecord, tfrecord)],
    ids=["torch-torch", "torch-jax", "jax-torch"])
def test_tfrecord_round_trip_and_cross_reading(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    features = [
        {"a": [b"xy", b""], "b": [1.5, -2.25], "c": [7, -2, 2**40]},
        {"image_data": [rng.bytes(3000)], "text_index": [3]},
        {"empty": []},
    ]
    path = str(tmp_path / "x.tfrecord")
    with writer.TFRecordWriter(path) as w:
        for f in features:
            w.write(writer.build_example(f))
    payloads = list(reader.TFRecordReader(path, check_crc=True))
    assert len(payloads) == len(features)
    for payload, want in zip(payloads, features):
        got = reader.parse_example(payload)
        assert set(got) == set(want)
        for key, values in want.items():
            if values and isinstance(values[0], float):
                np.testing.assert_allclose(got[key], values)
            else:
                assert [bytes(v) if isinstance(v, (bytes, bytearray, memoryview)) else v
                        for v in got[key]] == values


def test_tfrecord_bytes_and_crc_equal(tmp_path):
    feats = {"image_key": [b"k"], "label": [1], "w": [0.5]}
    assert tfrecord.build_example(feats) == jax_tfrecord.build_example(feats)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for module, path in ((tfrecord, a), (jax_tfrecord, b)):
        with module.TFRecordWriter(path) as w:
            w.write(module.build_example(feats))
    assert open(a, "rb").read() == open(b, "rb").read()
    bad = bytearray(open(a, "rb").read())
    bad[-6] ^= 0xFF
    open(a, "wb").write(bytes(bad))
    with pytest.raises(Exception):
        list(tfrecord.TFRecordReader(a, check_crc=True))


# ---------------------------------------------------------------------- text


@pytest.mark.parametrize("text", STRINGS, ids=[f"s{i}" for i in range(len(STRINGS))])
def test_tokenizer_ids_equal(tmp_path, text):
    vocab = _vocab_file(tmp_path, TEXT_VOCAB)
    want = JaxTokenizer(vocab).tokenize(text)
    assert BertTokenizer(vocab).tokenize(text) == want
    assert NativeBertTokenizer(vocab).tokenize(text) == want


@pytest.mark.parametrize("budget", [0, 3, 4, 5, 10])
def test_trimmer_equal(budget):
    cases = [
        [[[1, 2], [3], [4, 5, 6]], [[7], [8, 9]]],
        [[[1], [2], [3]], [[4], [5], [6]]],
        [[[1, 2, 3, 4]], [[5]]],
        [[[1, 2], [3, 4, 5]]],
        [[[1]], [[2]], []],
    ]
    for fields in cases:
        assert round_robin_trim(fields, budget) == jax_round_robin_trim(fields, budget)
    assert round_robin_trim(cases[0], 5) == [[[1, 2], [3]], [[7], [8]]]


# ------------------------------------------------------------------ features


def test_patches_and_normalize_equal():
    rng = np.random.default_rng(1)
    image = rng.random((2, 32, 48, 3), dtype=np.float32)
    for use_std in (False, True):
        want = jax_patches.normalize_image(image, use_std)
        np.testing.assert_array_equal(patches.normalize_image(image, use_std), want)
        np.testing.assert_allclose(
            patches.normalize_image(torch.from_numpy(image), use_std).numpy(), want, atol=1e-6)
    want = jax_patches.extract_patches(image, 16)
    np.testing.assert_array_equal(patches.extract_patches(image, 16), want)
    np.testing.assert_array_equal(patches.extract_patches(image[0], 16), want[0])
    np.testing.assert_array_equal(
        patches.extract_patches(torch.from_numpy(image), 16).numpy(), want)


@pytest.mark.parametrize("img,txt", [(6, 5), (6, 0), (0, 4), (18, 20)])
def test_segment_ids_equal(img, txt):
    want = np.asarray(jax_attention_mask.make_segment_ids(16, img, txt))
    np.testing.assert_array_equal(make_segment_ids(16, img, txt).numpy(), want)
    np.testing.assert_array_equal(_segment_ids(16, img, txt), want)
    batched = make_segment_ids(16, torch.tensor([img, 3]), torch.tensor([txt, 2]))
    np.testing.assert_array_equal(batched[0].numpy(), want)
    assert batched.dtype == torch.int32


# ------------------------------------------------------------------ assembly


def _data_kwargs(vocab, **kw):
    return dict(vocab_filename=vocab, image_size=32, patch_size=16, max_seq_len=32, seed=7, **kw)


@pytest.mark.parametrize("case", [
    dict(), dict(flip=True), dict(shape=(40, 24)), dict(shape=(40, 24), flip=True),
    dict(raw_u8=True), dict(raw_u8=True, flip=True), dict(image=False), dict(text=False),
], ids=["square", "flip", "resize", "resize_flip", "raw", "raw_flip", "text_only", "image_only"])
def test_assembler_equal(tmp_path, case):
    vocab = _vocab_file(tmp_path)
    rng = np.random.default_rng(2)
    image = _png(rng, *case.get("shape", (32, 32))) if case.get("image", True) else None
    fields = None
    if case.get("text", True):
        fields = {"caption_attribution_description": " ".join(rng.choice(WORDS, size=40)),
                  "caption_reference_description": "red wool zzz dress"}
    kw = dict(flip=case.get("flip", False), raw_u8=case.get("raw_u8", False),
              extras={"image_index": 3})
    got = ExampleAssembler(MmtRetrievalDataConfig(**_data_kwargs(vocab)),
                           BertTokenizer(vocab)).assemble(image, fields, **kw)
    jax_assembler = JaxAssembler(JaxRetrievalConfig(**_data_kwargs(vocab)), JaxTokenizer(vocab))
    want = jax_assembler.assemble(image, fields, **kw)
    np.testing.assert_array_equal(got.patch_token_ids, want.patch_token_ids)
    assert len(got.text_token_words) == len(want.text_token_words)
    for a, b in zip(got.text_token_words, want.text_token_words):
        np.testing.assert_array_equal(a, b)
    for name in ("patch_embeddings", "unnormalized_patch_embeddings", "text_selectable"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_image_wordpieces, got.num_text_wordpieces) == \
        (want.num_image_wordpieces, want.num_text_wordpieces)
    assert got.extras.keys() == want.extras.keys()
    for key in got.extras:
        np.testing.assert_array_equal(got.extras[key], want.extras[key])
    text_ids = got.text_token_words
    np.testing.assert_array_equal(
        ExampleAssembler(MmtRetrievalDataConfig(**_data_kwargs(vocab)), BertTokenizer(vocab))
        .finalize_word_ids(got.patch_token_ids, np.concatenate(text_ids or [np.zeros(0, np.int32)])),
        jax_assembler.finalize_word_ids(
            want.patch_token_ids, jax_assembler.flat_text_ids(want.text_token_words)))


# WIT-like sources to the model's 224 (downscale on one axis, upscale on the
# other, a larger image), and one small upscale.
RESIZE_CASES = [((192, 256), 224), ((256, 192), 224), ((200, 300), 224), ((480, 640), 224),
                ((24, 40), 32)]
RESIZE_IDS = ["192x256", "256x192", "200x300", "480x640", "up24x40"]


def _resize_assemblers(tmp_path, size):
    """The port's and the JAX package's assemblers at image_size ``size``
    (patch 16), over a vocab with an unused token for every patch."""
    vocab = _vocab_file(tmp_path, VOCAB[:8] + [f"[unused{i}]" for i in range(99, 99 + 200)])
    kw = dict(vocab_filename=vocab, image_size=size, patch_size=16, max_seq_len=300, seed=7)
    return (ExampleAssembler(MmtRetrievalDataConfig(**kw), BertTokenizer(vocab)),
            JaxAssembler(JaxRetrievalConfig(**kw), JaxTokenizer(vocab)))


@pytest.mark.parametrize("shape,size", RESIZE_CASES, ids=RESIZE_IDS)
def test_resize_bit_equal(tmp_path, shape, size):
    """The port's resize gathers and widens in another order than the JAX
    package's but does the same float64 operations: equal bit for bit on
    uint8 and on normalized float32 sources."""
    port, jax_assembler = _resize_assemblers(tmp_path, size)
    u8 = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    normalized = patches.normalize_image(np.true_divide(u8, 255, dtype=np.float32))
    for image in (u8, normalized):
        got, want = port.resize(image), jax_assembler.resize(image)
        assert got.dtype == want.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("shape,size", RESIZE_CASES, ids=RESIZE_IDS)
def test_image_features_bit_equal(tmp_path, shape, size, flip):
    port, jax_assembler = _resize_assemblers(tmp_path, size)
    image = _png(np.random.default_rng(sum(shape) + 1), *shape)
    got = port.image_features(image, flip=flip)
    want = jax_assembler.image_features(image, flip=flip)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name].view(np.uint32), want[name].view(np.uint32),
                                      err_msg=name)


def test_assembler_raw_image_needs_model_size(tmp_path):
    vocab = _vocab_file(tmp_path)
    assembler = ExampleAssembler(MmtRetrievalDataConfig(**_data_kwargs(vocab)),
                                 BertTokenizer(vocab))
    with pytest.raises(ValueError, match="ship_raw_images requires 32x32"):
        assembler.assemble(_png(np.random.default_rng(0), 40, 24), None, raw_u8=True)


# -------------------------------------------------------------------- loader


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _both(kwargs, **load):
    got = list(MmtRetrievalLoader(MmtRetrievalDataConfig(**kwargs)).load(**load))
    want = list(JaxRetrievalLoader(JaxRetrievalConfig(**kwargs)).load(**load))
    _assert_batches_equal(got, want)
    return got


@pytest.mark.parametrize("case", ["paired", "cross", "overflow_tail", "two_shards", "raw_images",
                                  "two_files"])
def test_retrieval_loader_batches_equal(tmp_path, case):
    rng = np.random.default_rng(3)
    vocab = _vocab_file(tmp_path)
    if case == "paired":
        path = _write_records(tfrecord, str(tmp_path / "p.tfrecord"), 5, rng)
        batches = _both(_data_kwargs(vocab, input_path=path, global_batch_size=4))
        assert [int(b["valid"].sum()) for b in batches] == [4, 1]  # the padded final batch
        assert np.all(batches[0]["label_ids"] == 1)
        assert batches[1]["image_index"][1:].tolist() == [-1, -1, -1]
        return
    imgs = _write_records(tfrecord, str(tmp_path / "img-0.tfrecord"), 3, rng, image_only=True)
    txts = _write_records(jax_tfrecord, str(tmp_path / "txt-0.tfrecord"), 5, rng,
                          text_only=True)
    if case == "two_files":
        _write_records(tfrecord, str(tmp_path / "txt-1.tfrecord"), 2, rng, text_only=True)
        txts = str(tmp_path / "txt-*.tfrecord")
    kwargs = _data_kwargs(vocab, image_input_path=imgs, text_input_path=txts,
                          num_image_examples=3, num_text_examples=5, global_batch_size=4)
    if case == "overflow_tail":
        full = _both(kwargs)
        capped = _both({**kwargs, "max_cached_text_examples": 2})
        _assert_batches_equal(capped, full)
    elif case == "two_shards":
        seen = []
        for shard in range(2):
            for b in _both(kwargs, shard_index=shard, num_shards=2, batch_size=3):
                seen += [(int(i), int(t)) for i, t, v in
                         zip(b["image_index"], b["text_index"], b["valid"]) if v]
        assert sorted(seen) == [(i, t) for i in range(3) for t in range(5)]
    elif case == "raw_images":
        raw = _both({**kwargs, "ship_raw_images": True})
        host = _both(kwargs)
        assert raw[0]["images"].dtype == np.uint8 and "patch_embeddings" not in raw[0]
        on_device = patches.extract_patches(patches.normalize_image(
            torch.from_numpy(raw[0]["images"]).float() / 255.0), 16)
        np.testing.assert_allclose(on_device.numpy(), host[0]["patch_embeddings"], atol=1e-6)
    else:
        batches = _both(kwargs)
        num_pairs = 15 if case == "cross" else 21
        assert sum(int(b["valid"].sum()) for b in batches) == num_pairs
        assert int(batches[-1]["valid"].sum()) == num_pairs % 4
        assert all(b["word_ids"].shape == (4, 32) for b in batches)


def test_glob_shard_and_cursor_equal(tmp_path):
    rng = np.random.default_rng(5)
    for i in range(3):
        _write_records(tfrecord, str(tmp_path / f"r-{i}.tfrecord"), 2 + i, rng, text_only=True)
    pattern = str(tmp_path / "r-*.tfrecord")
    for shard, n, seed in [(0, 1, None), (1, 2, None), (0, 4, None), (1, 2, 9)]:
        assert _glob_shard(pattern, shard, n, seed=seed) == \
            jax_glob_shard(pattern, shard, n, seed=seed)
    with pytest.raises(ValueError, match="does not match any files"):
        _glob_shard(str(tmp_path / "nope*"), 0, 1)
    whole = list(RecordCursor(pattern, 0, 1, None, repeat=False))
    assert len(whole) == 9
    strided = list(RecordCursor(pattern, 1, 4, None, repeat=False))  # fewer files than shards
    assert strided == whole[1::4]
    cursor = RecordCursor(pattern, 0, 1, None, repeat=False)
    cursor.seek(0, 5)
    assert next(cursor) == whole[5] and cursor.state() == (0, 6)


def test_loader_needs_a_vocab_and_no_rand_aug(tmp_path):
    with pytest.raises(ValueError, match="vocab_filename required"):
        MmtRetrievalLoader(MmtRetrievalDataConfig())
    vocab = _vocab_file(tmp_path)
    loader = MmtRetrievalLoader(MmtRetrievalDataConfig(**_data_kwargs(vocab, use_rand_aug=True)))
    payload = tfrecord.build_example({"image_data": [_png(np.random.default_rng(0))]})
    # RandAugment in training draws from the loader's rng, as JAX's does.
    want = JaxRetrievalLoader(JaxRetrievalConfig(**_data_kwargs(vocab, use_rand_aug=True)))
    for seed in range(4):
        got = loader._decode(payload, np.random.default_rng(seed), True)
        ref = want._decode(payload, np.random.default_rng(seed), True)
        np.testing.assert_array_equal(got.patch_embeddings, ref.patch_embeddings)
    assert loader._decode(payload, np.random.default_rng(0), False).patch_embeddings.shape == \
        (4, 768)


def test_native_library_failure_is_remembered(tmp_path, monkeypatch):
    """Without a loadable libmmt_data.so the port tries one build per
    process, then stays on the pure-Python path without asking again (the
    loader asks per record, per image and per string)."""
    import subprocess

    from mmt_tpu_torch.data import native

    calls = []

    def failing_build(cmd, **kwargs):
        calls.append(cmd)
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "libmmt_data.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_unavailable", False)
    monkeypatch.setattr(native.subprocess, "run", failing_build)
    monkeypatch.setattr(native.ctypes.util, "find_library", lambda name: f"lib{name}.so.62")
    assert not native.available() and not native.jpeg_available()
    assert native.decode_jpeg(b"\xff\xd8 not a jpeg") is None
    vocab = _vocab_file(tmp_path, TEXT_VOCAB)
    tokenizer = NativeBertTokenizer(vocab)
    for text in STRINGS:
        assert tokenizer.tokenize(text) == BertTokenizer(vocab).tokenize(text)
    assert len(calls) == 1

    bad = tmp_path / "bad.so"  # present but not loadable: no build, one load attempt
    bad.write_bytes(b"not an ELF file")
    monkeypatch.setattr(native, "_SO_PATH", str(bad))
    monkeypatch.setattr(native, "_unavailable", False)
    assert not native.available() and native._unavailable and len(calls) == 1


def test_native_build_skipped_without_libjpeg(tmp_path, monkeypatch):
    """Where no libjpeg is found the port attempts no build (it could not
    link) and reads the same records on the pure-Python path."""
    from mmt_tpu_torch.data import native

    rng = np.random.default_rng(5)
    path = str(tmp_path / "r.tfrecord")
    _write_records(tfrecord, path, 6, rng)
    want = list(tfrecord.TFRecordReader(path))
    calls = []
    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "libmmt_data.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_unavailable", False)
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(native.ctypes.util, "find_library", lambda name: None)
    assert not native.available() and native._unavailable and not native.jpeg_available()
    cursor = RecordCursor(path, 0, 1, seed=0, repeat=False)
    assert not cursor._use_native
    got = list(cursor)
    assert calls == [] and len(want) == 6 and got == want
