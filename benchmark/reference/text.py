"""The reference's caption path: BERT-uncased basic + WordPiece tokenization
and GroundingDINO's per-phrase masks (`bertwarper.py:224-273` of the
upstream repository), in numpy. A frozen copy of the mathematics; it
imports nothing of the measured program.

`make_vocab` builds the synthetic vocabulary that stands in for the absent
`vocab.txt`: the specials, '.', '?', ',', every word of the given names
and the single characters as fallback pieces. The benchmark hands the same
vocabulary to the measured program's tokenizer.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence

import numpy as np


def make_vocab(words: Sequence[str]) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    for w in ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "?", ","]:
        vocab[w] = len(vocab)
    for w in words:
        for piece in (w, w.lower()):
            vocab.setdefault(piece, len(vocab))
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        for piece in (c, "##" + c):
            vocab.setdefault(piece, len(vocab))
    return vocab


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _basic(text: str) -> List[str]:
    out, buf = [], []
    for ch in unicodedata.normalize("NFC", text):
        if ord(ch) in (0, 0xFFFD) or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        if ch.isspace() or _punct(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            if not ch.isspace():
                out.append(ch)
            continue
        buf.append(ch)
    if buf:
        out.append("".join(buf))
    norm = []
    for tok in out:
        tok = unicodedata.normalize("NFD", tok.lower())
        tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        if tok:
            norm.append(tok)
    return norm


def encode(vocab: Dict[str, int], text: str) -> List[int]:
    ids = [vocab["[CLS]"]]
    for word in _basic(text):
        start, pieces = 0, []
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in vocab:
                    cur = vocab[piece]
                    break
                end -= 1
            if cur is None:
                pieces = [vocab["[UNK]"]]
                break
            pieces.append(cur)
            start = end
        ids.extend(pieces)
    return ids + [vocab["[SEP]"]]


def text_batch(vocab: Dict[str, int], captions: Sequence[str], buckets: Sequence[int],
               max_text_len: int = 256, max_categories: int = 90) -> Dict[str, np.ndarray]:
    """Token ids padded to the smallest bucket that holds the longest
    caption; the valid-token mask; per-phrase block masks and position ids
    (a phrase ends at [CLS], [SEP], '.' or '?'); the category -> token map."""
    enc = [encode(vocab, c)[:max_text_len] for c in captions]
    longest = max(len(e) for e in enc)
    t = next((b for b in buckets if longest <= b), buckets[-1])
    t = min(t, max_text_len)
    b = len(enc)
    ids = np.full((b, t), vocab["[PAD]"], np.int64)
    valid = np.zeros((b, t), bool)
    for i, e in enumerate(enc):
        ids[i, :len(e[:t])] = e[:t]
        valid[i, :len(e[:t])] = True
    special = np.isin(ids, [vocab[k] for k in ("[CLS]", "[SEP]", ".", "?") if k in vocab])
    attn = np.zeros((b, t, t), bool)
    attn[:, np.arange(t), np.arange(t)] = True
    pos = np.zeros((b, t), np.int64)
    c2t = np.zeros((b, max_categories, t), bool)
    for row in range(b):
        prev, ci = 0, 0
        for col in np.flatnonzero(special[row]):
            col = int(col)
            if col not in (0, t - 1):
                attn[row, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[row, prev + 1:col + 1] = np.arange(0, col - prev)
                if ci < max_categories and col > prev + 1:
                    c2t[row, ci, prev + 1:col] = True
                    ci += 1
            prev = col
    return {"input_ids": ids, "text_token_mask": valid, "position_ids": pos,
            "text_self_attention_masks": attn, "cate_to_token_mask": c2t}


def caption(names: Sequence[str]) -> str:
    return ".".join(n.lower().strip() for n in names) + "."
