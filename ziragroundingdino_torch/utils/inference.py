"""User-facing inference API, the port of the JAX package's `utils/
inference.py` (reference `util/inference.py:24-97` and the demo's phrase
extraction, `util/utils.py:598`): `load_model`, `predict`,
`predict_classes` and `get_phrases_from_posmap`.

Every forward runs under `torch.inference_mode()` on the model's device.
Images come in already normalized and padded to a bucket:
`data.transforms.load_image` reads, resizes and pads one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ziragroundingdino_torch.config import GroundingDINOConfig
from ziragroundingdino_torch.models import GroundingDINO, build_model
from ziragroundingdino_torch.text.masks import recover_to_cls_logits
from ziragroundingdino_torch.text.tokenizer import (
    TextBatch,
    WordPieceTokenizer,
    build_captions,
    load_vocab,
    tokenize_captions,
)

# keys of a reference checkpoint that the port does not hold: buffers it
# recomputes and modules it does not use for serving
_DROPPED_KEYS = ("bert.pooler.", "bert.embeddings.position_ids", "relative_position_index",
                 "attn_mask", "label_enc.")
# per-class prompt memory (`groundingdino_dt.py:424-432`): ragged [n_tokens, E]
# embeddings, kept beside the model (`LoadedModel.prompt_memory`)
PROMPT_PREFIX = "prompt_memory_pool."


@dataclass
class LoadedModel:
    model: GroundingDINO
    tokenizer: WordPieceTokenizer
    # "-name-" -> that class's stored token embeddings [n_tokens, E]
    prompt_memory: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def cfg(self) -> GroundingDINOConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def load_model(
    state_dict_path: str,
    vocab_path: str,
    preset: str = "dualzerorepbranchgroundingdino",
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[Union[str, torch.dtype]] = None,
    **overrides,
) -> LoadedModel:
    """Build `preset` and load a reference-format state dict (a `.pth` holding
    the state dict, or `{"model": state_dict}`) with `torch.load`.
    `vocab_path` is bert-base-uncased's vocab.txt. The checkpoint's
    `prompt_memory_pool.<name>` entries become `LoadedModel.prompt_memory`
    (`utils/torch_convert.py:323-325` of the JAX package)."""
    model = build_model(preset, device=device, dtype=dtype, **overrides)
    ckpt = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    prompt_memory = {k[len(PROMPT_PREFIX):]: v.numpy() for k, v in sd.items()
                     if k.startswith(PROMPT_PREFIX)}
    sd = {k: v for k, v in sd.items()
          if not k.startswith(PROMPT_PREFIX) and not any(d in k for d in _DROPPED_KEYS)}
    model.load_state_dict(sd, strict=True)
    return LoadedModel(model=model, tokenizer=WordPieceTokenizer(load_vocab(vocab_path)),
                       prompt_memory=prompt_memory)


def get_phrases_from_posmap(
    posmap: np.ndarray,  # [T] bool
    input_ids: Sequence[int],
    tokenizer: WordPieceTokenizer,
    left_idx: int = 0,
    right_idx: int = 255,
) -> str:
    """`util/utils.py:598-620`: decode the tokens whose logit exceeds the
    text threshold into a phrase."""
    posmap = np.asarray(posmap).copy()
    posmap[: left_idx + 1] = False
    posmap[right_idx:] = False
    inv = {v: k for k, v in tokenizer.vocab.items()}
    words: List[str] = []
    for i in np.flatnonzero(posmap):
        piece = inv.get(int(input_ids[i]), "[UNK]")
        if piece.startswith("##") and words:
            words[-1] += piece[2:]
        else:
            words.append(piece)
    return " ".join(words)


def _forward(lm: LoadedModel, pixels, mask, tb: TextBatch) -> Dict[str, torch.Tensor]:
    dev = lm.device
    pixels = torch.as_tensor(pixels).to(dev)
    mask = torch.as_tensor(mask).to(dev)
    text = {k: torch.from_numpy(v).to(dev) for k, v in tb.asdict().items()}
    with torch.inference_mode():
        return lm.model(pixels, mask, text)


def predict(
    lm: LoadedModel,
    pixels: Union[np.ndarray, torch.Tensor],  # [1, H, W, 3] normalized or uint8
    mask: Union[np.ndarray, torch.Tensor],  # [1, H, W] bool
    caption: str,
    box_threshold: float = 0.35,
    text_threshold: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """`util/inference.py:48-97`: returns (boxes cxcywh normalized [N, 4],
    confidence [N], phrases [N])."""
    caption = caption.lower().strip()
    if not caption.endswith("."):
        caption += "."
    tb = tokenize_captions(lm.tokenizer, [caption], max_text_len=lm.cfg.max_text_len,
                           max_categories=lm.cfg.max_categories)
    out = _forward(lm, pixels, mask, tb)
    t = tb.input_ids.shape[1]
    logits = torch.sigmoid(out["pred_logits"][0, :, :t].float()).cpu().numpy()
    boxes = out["pred_boxes"][0].float().cpu().numpy()
    keep = logits.max(axis=1) > box_threshold
    logits, boxes = logits[keep], boxes[keep]
    phrases = [get_phrases_from_posmap(l > text_threshold, tb.input_ids[0], lm.tokenizer,
                                       right_idx=t - 1)
               for l in logits]
    return boxes, logits.max(axis=1), phrases


def predict_classes(
    lm: LoadedModel,
    pixels: Union[np.ndarray, torch.Tensor],
    mask: Union[np.ndarray, torch.Tensor],
    class_names: Sequence[str],
    box_threshold: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Per-class mode (`demo/inference_on_a_image_multi_classes.py`): caption =
    joined class names, class of each box = argmax over per-category
    recovered logits."""
    caption = build_captions([c.lower().strip() for c in class_names])
    tb = tokenize_captions(lm.tokenizer, [caption], max_text_len=lm.cfg.max_text_len,
                           max_categories=max(len(class_names), 1))
    out = _forward(lm, pixels, mask, tb)
    t = tb.input_ids.shape[1]
    cls_logits = recover_to_cls_logits(
        out["pred_logits"][:, :, :t],
        torch.from_numpy(tb.cate_to_token_mask).to(out["pred_logits"].device))
    probs = torch.sigmoid(cls_logits[0]).float().cpu().numpy()  # [Q, C]
    boxes = out["pred_boxes"][0].float().cpu().numpy()
    best = probs.max(axis=1)
    keep = best > box_threshold
    labels = probs.argmax(axis=1)[keep]
    return boxes[keep], best[keep], [class_names[i] for i in labels]
