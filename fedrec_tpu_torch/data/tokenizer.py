"""Offline tokenizers producing the ``bert_news_index`` artifact format: a
copy of ``fedrec_tpu/data/tokenizer.py`` (the port imports nothing of the
JAX package); the same text gives the same (2, L) id/mask frame.

The reference ships pre-tokenized artifacts (``UserData/bert_news_index.npy``:
int64 ``(N, 2, L)`` = stacked [token_ids; attention_mask]) but not the
pipeline that produced them. Two tokenizers, no network access:

  * ``WordPieceTokenizer`` — BERT-uncased-compatible: basic tokenization
    (lowercase, accent-strip, punctuation split) + greedy longest-match
    WordPiece against a local ``vocab.txt``.
  * ``HashingTokenizer`` — the deterministic fallback when no vocab file is
    given: whitespace+punct words hashed into the vocab range. Unsuitable
    for pretrained-weight runs, fine for from-scratch training and smoke
    tests.
"""

from __future__ import annotations

import hashlib
import unicodedata
from pathlib import Path

import numpy as np

# BERT special token ids (bert-base-uncased vocab layout)
PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = 0, 100, 101, 102, 103


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """Whitespace + punctuation splitting with accent stripping (BERT basic)."""
    if lowercase:
        text = text.lower()
    text = unicodedata.normalize("NFD", text)
    out: list[str] = []
    word: list[str] = []
    for ch in text:
        if unicodedata.category(ch) == "Mn":  # strip accents
            continue
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punctuation(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a BERT ``vocab.txt``."""

    def __init__(self, vocab_path: str | Path, lowercase: bool = True):
        self.vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.lowercase = lowercase
        self.pad_id = self.vocab.get("[PAD]", PAD_ID)
        self.unk_id = self.vocab.get("[UNK]", UNK_ID)
        self.cls_id = self.vocab.get("[CLS]", CLS_ID)
        self.sep_id = self.vocab.get("[SEP]", SEP_ID)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _word_ids(self, word: str, max_chars: int = 100) -> list[int]:
        if len(word) > max_chars:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (ids, mask), each (max_len,) int64, [CLS] ... [SEP] + pad."""
        return _frame(self, text, max_len)


class HashingTokenizer:
    """Deterministic hashed-word ids — the no-vocab-file fallback.

    Ids land in ``[n_special, vocab_size)``; special ids keep the BERT layout
    so artifacts stay drop-in compatible with the model's embedding table.
    """

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id, self.cls_id, self.sep_id = PAD_ID, CLS_ID, SEP_ID
        self._floor = MASK_ID + 1

    def _word_ids(self, word: str) -> list[int]:
        h = int.from_bytes(hashlib.sha1(word.encode("utf-8")).digest()[:8], "little")
        return [self._floor + h % (self.vocab_size - self._floor)]

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
        return _frame(self, text, max_len)


def _frame(tok, text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Shared [CLS] + word ids + truncate + [SEP] + pad/mask framing."""
    ids = [tok.cls_id]
    for w in basic_tokenize(text, tok.lowercase):
        ids.extend(tok._word_ids(w))
        if len(ids) >= max_len - 1:
            break
    ids = ids[: max_len - 1] + [tok.sep_id]
    mask = np.zeros(max_len, np.int64)
    mask[: len(ids)] = 1
    out = np.full(max_len, tok.pad_id, np.int64)
    out[: len(ids)] = ids
    return out, mask


def get_tokenizer(
    vocab_path: str | Path | None = None, vocab_size: int = 30522
) -> WordPieceTokenizer | HashingTokenizer:
    """WordPiece when a vocab file is given (must exist), hashing fallback
    only when no vocab was requested — a silently-wrong tokenizer would waste
    a whole preprocessing + training cycle."""
    if vocab_path is not None:
        if not Path(vocab_path).exists():
            raise FileNotFoundError(f"vocab file not found: {vocab_path}")
        return WordPieceTokenizer(vocab_path)
    return HashingTokenizer(vocab_size)
