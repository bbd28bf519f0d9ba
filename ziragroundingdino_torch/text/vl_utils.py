"""Vision-language span utilities, the port of the JAX package's
`text/vl_utils.py` (reference `util/vl_utils.py`):

* `build_captions_and_token_span` (`:49-89`): category names joined into a
  caption, with each category's character span;
* `create_positive_map_from_span` (`:8-46`): character spans to a token
  positive map, through the tokens' character offsets (`encode_with_offsets`,
  in place of the HF tokenizer's `char_to_token`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer


def build_captions_and_token_span(cat_list: Sequence[str], force_lowercase: bool = True
                                  ) -> Tuple[str, Dict[str, List[Tuple[int, int]]]]:
    """('a . b . c .', {name: [(start, end)]}): the names joined by ' . '
    with a final ' .', and each name's character span."""
    cat2span: Dict[str, List[Tuple[int, int]]] = {}
    caption = ""
    for name in cat_list:
        if force_lowercase:
            name = name.lower()
        if caption:
            caption += " . "
        start = len(caption)
        caption += name
        cat2span[name] = [(start, len(caption))]
    caption += " ."
    return caption, cat2span


def encode_with_offsets(tokenizer: WordPieceTokenizer,
                        text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
    """(token ids with [CLS] and [SEP], each token's (char_start, char_end)).
    A word is found in the text from the end of the one before; a word cut
    into k pieces gives each piece the next max(1, len // k) of its
    characters, within the word. [CLS] is (0, 0) and [SEP] (len, len)."""
    ids: List[int] = [tokenizer.cls_id]
    offsets: List[Tuple[int, int]] = [(0, 0)]
    pos = 0
    lowered = text.lower() if tokenizer.lowercase else text
    for word in tokenizer._basic(text):
        # basic tokenization keeps the order; a word changed by it (accents
        # stripped) is not found and starts where the last one ended
        found = lowered.find(word, pos)
        start = found if found >= 0 else pos
        pieces = tokenizer._wordpiece(word)
        n = len(word)
        cursor = start
        for pid in pieces:
            if len(pieces) == 1:
                span = (start, start + n)
            else:
                plen = max(1, n // len(pieces))
                span = (cursor, min(cursor + plen, start + n))
                cursor = span[1]
            ids.append(pid)
            offsets.append(span)
        pos = start + n
    ids.append(tokenizer.sep_id)
    offsets.append((len(text), len(text)))
    return ids, offsets


def create_positive_map_from_span(tokenizer: WordPieceTokenizer, caption: str,
                                  token_spans: Sequence[Sequence[Tuple[int, int]]],
                                  max_text_len: int = 256) -> np.ndarray:
    """[num_phrases, max_text_len] positive map, each row normalized to sum
    1: a token is positive for a phrase where its characters overlap one of
    the phrase's spans."""
    ids, offsets = encode_with_offsets(tokenizer, caption)
    t = min(len(ids), max_text_len)
    positive = np.zeros((len(token_spans), max_text_len), np.float32)
    for j, spans in enumerate(token_spans):
        for beg, end in spans:
            for ti in range(t):
                s, e = offsets[ti]
                if s != e and s < end and e > beg:
                    positive[j, ti] = 1.0
    norm = positive.sum(-1, keepdims=True)
    return positive / np.clip(norm, 1e-6, None)
