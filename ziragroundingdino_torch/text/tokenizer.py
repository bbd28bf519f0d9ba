"""Native BERT (uncased) tokenizer + text-batch builder.

The port's numpy copy of the JAX package's `text/tokenizer.py`. The
reference loads the HF tokenizer (`util/get_tokenlizer.py:15-26`) and
tokenizes captions inside model.forward (`groundingdino.py:262-264`). Here
tokenization is a host-side preprocessing step (strings never reach the
device) producing arrays padded to a few static lengths.

The tokenizer is a from-spec implementation of BERT basic+WordPiece
tokenization (lowercase, punctuation splitting, CJK spacing, accent
stripping, greedy longest-match subwords). It is vocabulary-driven: pass the
`vocab.txt` that ships with `bert-base-uncased` (same file the HF tokenizer
reads) to reproduce the reference's ids exactly.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ziragroundingdino_torch.text.masks import generate_special_token_masks


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-uncased basic + WordPiece tokenization."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_chars_per_word: int = 100,
        lowercase: bool = True,
    ):
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word
        self.lowercase = lowercase
        # ids of [CLS] [SEP] . ? — the caption split points
        # (`groundingdino.py:130`)
        self.special_ids: Tuple[int, ...] = tuple(
            vocab[t] for t in (cls_token, sep_token, ".", "?") if t in vocab
        )

    # -- basic tokenization ------------------------------------------------
    def _basic(self, text: str) -> List[str]:
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                out.append("".join(buf))
                buf.clear()

        text = unicodedata.normalize("NFC", text)
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            if ch.isspace():
                flush()
                continue
            if _is_cjk(cp) or _is_punctuation(ch):
                flush()
                out.append(ch)
                continue
            buf.append(ch)
        flush()

        if self.lowercase:
            norm = []
            for tok in out:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
                if tok:
                    norm.append(tok)
            out = norm
        return out

    # -- wordpiece ----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
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

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for word in self._basic(text):
            ids.extend(self._wordpiece(word))
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids


@dataclass
class TextBatch:
    """Device-ready text arrays (all fixed shape)."""

    input_ids: np.ndarray  # [B, T] int32
    text_token_mask: np.ndarray  # [B, T] bool True=valid
    position_ids: np.ndarray  # [B, T] int32
    text_self_attention_masks: np.ndarray  # [B, T, T] bool True=attend
    cate_to_token_mask: np.ndarray  # [B, C, T] bool
    num_categories: np.ndarray  # [B] int32

    def asdict(self) -> Dict[str, np.ndarray]:
        return {
            "input_ids": self.input_ids,
            "text_token_mask": self.text_token_mask,
            "position_ids": self.position_ids,
            "text_self_attention_masks": self.text_self_attention_masks,
        }


def round_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def build_captions(category_names: Sequence[str]) -> str:
    """`detr_dataset_mapper.py:111-113`: '. '-free join with trailing dot."""
    return ".".join(category_names) + "."


def tokenize_captions(
    tokenizer: WordPieceTokenizer,
    captions: Sequence[str],
    max_text_len: int = 256,
    max_categories: int = 90,
    text_len_buckets: Sequence[int] = (64, 128, 192, 256),
) -> TextBatch:
    """Tokenize + pad to a static bucket and build the block-diagonal masks
    (the host half of `groundingdino.py:262-281` + `bertwarper.py:224-273`)."""
    encoded = [tokenizer.encode(c)[:max_text_len] for c in captions]
    longest = max(len(e) for e in encoded)
    t = min(round_to_bucket(longest, text_len_buckets), max_text_len)

    b = len(encoded)
    input_ids = np.full((b, t), tokenizer.pad_id, dtype=np.int32)
    attn = np.zeros((b, t), dtype=bool)
    for i, e in enumerate(encoded):
        e = e[:t]
        input_ids[i, : len(e)] = e
        attn[i, : len(e)] = True

    m = generate_special_token_masks(
        input_ids, pad_to_text_len=t, max_categories=max_categories,
        special_ids=tokenizer.special_ids,
    )
    return TextBatch(
        input_ids=input_ids,
        text_token_mask=attn,
        position_ids=m["position_ids"],
        text_self_attention_masks=m["text_self_attention_masks"],
        cate_to_token_mask=m["cate_to_token_mask"],
        num_categories=m["num_categories"],
    )


def make_synthetic_vocab(words: Sequence[str]) -> Dict[str, int]:
    """Tiny vocab for tests (ids won't match bert-base-uncased)."""
    base = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "?", ","]
    vocab = {w: i for i, w in enumerate(base)}
    for w in words:
        for piece in (w, w.lower()):
            if piece not in vocab:
                vocab[piece] = len(vocab)
    # single characters as fallback pieces
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        for piece in (c, "##" + c):
            if piece not in vocab:
                vocab[piece] = len(vocab)
    return vocab
