"""Native (C++) WordPiece tokenizer with transparent Python fallback.

The port's own copy of ``mmt_tpu/text/native.py``, over the port's own
loader of ``native/libmmt_data.so``.

``NativeBertTokenizer`` is a drop-in for
:class:`mmt_tpu_torch.text.wordpiece.BertTokenizer`: same constructor, same
word-aligned ``tokenize``/``flat_tokenize`` output.  ASCII texts run
through the C++ fast path (``native/mmt_text.cc``, byte-exact with the
Python implementation -- asserted by ``tests/test_native_text.py``);
texts containing any non-ASCII byte, and environments where the native
library cannot be built, fall back to the Python tokenizer (full
Unicode semantics live there, where ``unicodedata`` is authoritative).

Reference counterpart: the C++ kernels behind
``tensorflow_text.BertTokenizer`` (``src/data/data_utils.py:88-104``).
"""

from __future__ import annotations

import ctypes
from typing import List

from mmt_tpu_torch.data import native as _data_native
from mmt_tpu_torch.text.wordpiece import BertTokenizer, load_vocab

_CAP = 1 << 16


def _bind(lib):
    if getattr(lib, "_mmt_text_bound", False):
        return lib
    lib.mmt_wp_create.restype = ctypes.c_void_p
    lib.mmt_wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.mmt_wp_free.argtypes = [ctypes.c_void_p]
    lib.mmt_wp_tokenize.restype = ctypes.c_int64
    lib.mmt_wp_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib._mmt_text_bound = True
    return lib


class NativeBertTokenizer:
    """BertTokenizer with a C++ ASCII fast path."""

    def __init__(self, vocab_path_or_dict, lower_case: bool = True):
        self._py = BertTokenizer(vocab_path_or_dict, lower_case=lower_case)
        self.vocab = self._py.vocab
        self._handle = None
        lib = _data_native._load()
        if lib is None:
            return
        lib = _bind(lib)
        # vocab ids must be the line index: emit a dense id->token table.
        size = max(self.vocab.values()) + 1 if self.vocab else 0
        table = [""] * size
        for tok, idx in self.vocab.items():
            table[idx] = tok
        blob = "\n".join(table).encode("utf-8")
        self._lib = lib
        self._handle = lib.mmt_wp_create(
            blob, len(blob), 1 if lower_case else 0
        )
        self._ids = (ctypes.c_int32 * _CAP)()
        self._ends = (ctypes.c_int32 * _CAP)()
        self._n_words = ctypes.c_int64()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mmt_wp_free(handle)
            self._handle = None

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def tokenize(self, text: str) -> List[List[int]]:
        if self._handle is None:
            return self._py.tokenize(text)
        raw = text.encode("utf-8", errors="surrogatepass")
        n = self._lib.mmt_wp_tokenize(
            self._handle, raw, len(raw), self._ids, self._ends, _CAP,
            ctypes.byref(self._n_words),
        )
        if n < 0:  # non-ASCII or overflow: Python handles it
            return self._py.tokenize(text)
        out: List[List[int]] = []
        start = 0
        for w in range(self._n_words.value):
            end = self._ends[w]
            out.append(list(self._ids[start:end]))
            start = end
        return out

    def flat_tokenize(self, text: str) -> List[int]:
        return [wp for word in self.tokenize(text) for wp in word]


__all__ = ["NativeBertTokenizer", "load_vocab"]
