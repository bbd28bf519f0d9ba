"""Caption structure: block-diagonal text masks and category->token maps.

The port's copy of the JAX package's `text/masks.py`, itself a
re-implementation of the reference's
`generate_masks_with_special_tokens_and_transfer_map`
(`models/GroundingDINO/bertwarper.py:224-273`). A caption
``"cat. dog. zebra."`` is split at [CLS]/[SEP]/./? into per-category
sub-sentences; tokens of one category only self-attend (block-diagonal
[T, T] mask), position ids restart at 0 in each block, and a category->token
map feeds the per-class max over token logits (`utils.py:312-320`).

The masks are per caption, so at batch > 1 every caption keeps its own mask
(the `repeat_interleave` semantics the JAX package pins; the reference's
`repeat(nhead, 1, 1)` mixes captions across the batch).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# bert-base-uncased ids for [CLS], [SEP], '.', '?'
SPECIAL_TOKEN_IDS: Tuple[int, ...] = (101, 102, 1012, 1029)


def generate_special_token_masks(
    input_ids: np.ndarray,
    pad_to_text_len: int | None = None,
    max_categories: int = 90,
    special_ids: Sequence[int] = SPECIAL_TOKEN_IDS,
):
    """Host-side mask generation (numpy).

    Args:
      input_ids: [B, T] int array from the tokenizer (0-padded).
      pad_to_text_len: output T' >= T to pad to; default T.
      max_categories: C; categories beyond this are dropped.

    Returns dict of numpy arrays:
      text_self_attention_masks: [B, T', T'] bool, True = may attend.
      position_ids:              [B, T'] int32, restart at 0 per block.
      cate_to_token_mask:        [B, C, T'] bool, token membership per category.
      num_categories:            [B] int32.
    """
    input_ids = np.asarray(input_ids)
    bs, num_token = input_ids.shape
    tp = int(pad_to_text_len or num_token)
    if tp < num_token:
        raise ValueError(f"pad_to_text_len {tp} < token count {num_token}")

    special = np.isin(input_ids, np.asarray(special_ids))

    attention_mask = np.zeros((bs, tp, tp), dtype=bool)
    attention_mask[:, np.arange(tp), np.arange(tp)] = True
    position_ids = np.zeros((bs, tp), dtype=np.int32)
    c2t = np.zeros((bs, max_categories, tp), dtype=bool)
    num_cate = np.zeros((bs,), dtype=np.int32)

    for row in range(bs):
        cols = np.flatnonzero(special[row])
        previous_col = 0
        ci = 0
        for col in cols:
            col = int(col)
            if col == 0 or col == num_token - 1:
                # [CLS] at 0 / trailing token: self-attention only, pos 0
                position_ids[row, col] = 0
            else:
                attention_mask[row, previous_col + 1 : col + 1, previous_col + 1 : col + 1] = True
                position_ids[row, previous_col + 1 : col + 1] = np.arange(0, col - previous_col)
                # only non-empty spans become categories
                if ci < max_categories and col > previous_col + 1:
                    c2t[row, ci, previous_col + 1 : col] = True
                    ci += 1
            previous_col = col
        num_cate[row] = ci

    return {
        "text_self_attention_masks": attention_mask,
        "position_ids": position_ids,
        "cate_to_token_mask": c2t,
        "num_categories": num_cate,
    }


def recover_to_cls_logits(
    token_logits: torch.Tensor,
    cate_to_token_mask: torch.Tensor,
    fill: float = -100.0,
) -> torch.Tensor:
    """Per-category max over member-token logits:
    ``out[b, q, c] = max_t token_logits[b, q, t] where mask[b, c, t]``;
    categories with no tokens get `fill`.

    token_logits [B, Q, T], cate_to_token_mask [B, C, T] bool -> [B, Q, C].
    """
    masked = torch.where(cate_to_token_mask[:, None, :, :], token_logits[:, :, None, :],
                         -float("inf"))
    out = masked.amax(dim=-1)
    has_tokens = cate_to_token_mask.any(dim=-1)
    return torch.where(has_tokens[:, None, :], out, torch.full_like(out, fill))
