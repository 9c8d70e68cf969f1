"""BERT-compatible WordPiece tokenization (host-side, pure Python).

The port's own copy of ``mmt_tpu/text/wordpiece.py``.

Re-provides the capability of ``tensorflow_text.BertTokenizer`` as used
by the reference (``src/data/data_utils.py:88-104, 253-259``):
lower-casing BasicTokenizer + greedy longest-match-first WordPiece with
``preserve_unused_token=True`` semantics -- bracketed special tokens of
the form ``[unusedNN]``, ``[CLS]``, ``[SEP]``, ``[MASK]``, ``[ATT]``,
``[REF]``, ``[PATCH]`` etc. present in the vocab are never split.

Output is *word-aligned*: ``tokenize`` returns one list of wordpiece ids
per word, the structure whole-word masking operates on (the ragged
[words, wordpieces] axis of the reference pipeline).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (
        (33 <= cp <= 47)
        or (58 <= cp <= 64)
        or (91 <= cp <= 96)
        or (123 <= cp <= 126)
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """BERT basic tokenizer: cleanup, CJK spacing, lowercasing, punct split."""

    def __init__(self, lower_case: bool = True, preserve_tokens: Sequence[str] = ()):
        self.lower_case = lower_case
        self.preserve = set(preserve_tokens)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._tokenize_chinese(text)
        tokens: List[str] = []
        for token in text.split():
            if token in self.preserve:
                tokens.append(token)
                continue
            if self.lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            tokens.extend(self._split_punct(token))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.extend([" ", ch, " "])
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, token: str) -> List[str]:
        if token in self.preserve:
            return [token]
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out if x]


class WordpieceTokenizer:
    """Greedy longest-match-first subword split."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 200):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertTokenizer:
    """Word-aligned BERT tokenization: text -> List[List[wordpiece ids]]."""

    def __init__(self, vocab_path_or_dict, lower_case: bool = True):
        self.vocab = (
            load_vocab(vocab_path_or_dict)
            if isinstance(vocab_path_or_dict, str)
            else dict(vocab_path_or_dict)
        )
        # preserve_unused_token semantics: any bracketed vocab token
        # ([CLS], [unused99], [ATT], ...) is unsplittable.
        preserve = [t for t in self.vocab if t.startswith("[") and t.endswith("]")]
        self.basic = BasicTokenizer(lower_case=lower_case, preserve_tokens=preserve)
        self.wordpiece = WordpieceTokenizer(self.vocab)

    def tokenize(self, text: str) -> List[List[int]]:
        words = self.basic.tokenize(text)
        out: List[List[int]] = []
        for word in words:
            if word in self.vocab and word in self.basic.preserve:
                out.append([self.vocab[word]])
                continue
            pieces = self.wordpiece.tokenize(word)
            out.append([self.vocab[p] for p in pieces])
        return out

    def flat_tokenize(self, text: str) -> List[int]:
        return [wp for word in self.tokenize(text) for wp in word]
