"""User-facing inference API, the port of the JAX package's `utils/
inference.py` (reference `util/inference.py:24-97` and the demo's phrase
extraction, `util/utils.py:598`): `load_model`, `predict`,
`predict_classes`, `get_phrases_from_posmap` and `annotate`.

Every forward runs under `torch.inference_mode()` on the model's device.
Images come in already normalized and padded to a bucket:
`data.transforms.load_image` reads, resizes and pads one.
"""

from __future__ import annotations

import logging
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
# recomputes or never reads and modules it does not use for serving (the
# JAX package's "<drop>" rules, `utils/torch_convert.py`)
_DROPPED_KEYS = ("bert.pooler.", "bert.embeddings.position_ids", "relative_position_index",
                 "attn_mask", "label_enc.", "num_batches_tracked")
# per-class prompt memory (`groundingdino_dt.py:424-432`): ragged [n_tokens, E]
# embeddings, kept beside the model (`LoadedModel.prompt_memory`)
PROMPT_PREFIX = "prompt_memory_pool."


@dataclass
class LoadedModel:
    model: GroundingDINO
    tokenizer: WordPieceTokenizer
    # "-name-" -> that class's stored token embeddings [n_tokens, E]
    prompt_memory: Dict[str, np.ndarray] = field(default_factory=dict)
    # what the non-strict load reported: the model's keys that the
    # checkpoint lacks (they keep their init), the checkpoint's keys that the
    # model does not have, and "key (shape a vs b)" for a shape mismatch
    # (that tensor keeps its init too)
    missing: List[str] = field(default_factory=list)
    unexpected: List[str] = field(default_factory=list)
    mismatched: List[str] = field(default_factory=list)

    @property
    def cfg(self) -> GroundingDINOConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def load_model(
    state_dict_path: str,
    vocab_path: str,
    preset: str = "groundingdino",
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[Union[str, torch.dtype]] = None,
    **overrides,
) -> LoadedModel:
    """Build `preset` and merge a reference-format state dict into it (a
    `.pth` holding the state dict, or `{"model": state_dict}`), read with
    `torch.load`. `vocab_path` is bert-base-uncased's vocab.txt. The merge is
    non-strict, as the JAX package's (`utils/torch_convert.py::merge_into`;
    the reference's `load_state_dict(strict=False)`): a key the checkpoint
    lacks keeps the model's init (so the released vanilla checkpoint loads
    into a ZiRa preset with zero freeze branches and fresh trainable ones),
    and unknown keys and shape mismatches are logged and returned in
    `LoadedModel.missing` / `unexpected` / `mismatched`, not raised. The
    checkpoint's `prompt_memory_pool.<name>` entries become
    `LoadedModel.prompt_memory` (`utils/torch_convert.py:323-325` of the
    JAX package)."""
    model = build_model(preset, device=device, dtype=dtype, **overrides)
    ckpt = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    prompt_memory = {k[len(PROMPT_PREFIX):]: v.numpy() for k, v in sd.items()
                     if k.startswith(PROMPT_PREFIX)}
    sd = {k: v for k, v in sd.items()
          if not k.startswith(PROMPT_PREFIX) and not any(d in k for d in _DROPPED_KEYS)}
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    mismatched = [f"{k} (shape {tuple(own[k].shape)} vs {tuple(v.shape)})"
                  for k, v in sd.items() if k in own and own[k].shape != v.shape]
    model.load_state_dict({k: v for k, v in sd.items()
                           if k in own and own[k].shape == v.shape}, strict=False)
    if missing or unexpected or mismatched:
        logging.getLogger("ziragroundingdino_torch").info(
            "checkpoint load (strict=False) into %s: %d missing keys (kept at init), "
            "%d unexpected, %d shape mismatches; unexpected %s, mismatched %s",
            preset, len(missing), len(unexpected), len(mismatched), unexpected[:10],
            mismatched[:10])
    return LoadedModel(model=model, tokenizer=WordPieceTokenizer(load_vocab(vocab_path)),
                       prompt_memory=prompt_memory, missing=missing, unexpected=unexpected,
                       mismatched=mismatched)


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


def _draw_box(img: np.ndarray, x0: float, y0: float, x1: float, y1: float,
              color: Tuple[int, int, int], width: int) -> None:
    """The outline of [x0, x1] x [y0, y1] (pixel coordinates), `width`
    pixels thick inside it as PIL's `rectangle` draws it, clipped to the
    image, in place."""
    h, w = img.shape[:2]
    xa, ya, xb, yb = (int(np.floor(v)) for v in (x0, y0, x1, y1))
    xa, xb = sorted((xa, xb))
    ya, yb = sorted((ya, yb))
    for t in range(width):
        top, bottom, left, right = ya + t, yb - t, xa + t, xb - t
        if top > bottom or left > right:
            break
        cl, cr = max(left, 0), min(right, w - 1)
        ct, cb = max(top, 0), min(bottom, h - 1)
        if cl > cr or ct > cb:
            break
        for y in (top, bottom):
            if 0 <= y < h:
                img[y, cl:cr + 1] = color
        for x in (left, right):
            if 0 <= x < w:
                img[ct:cb + 1, x] = color


def annotate(
    image_source: np.ndarray,  # [H, W, 3] uint8
    boxes: np.ndarray,  # [N, 4] cxcywh normalized
    logits: np.ndarray,
    phrases: List[str],
) -> np.ndarray:
    """Draw each box in red, 2 pixels wide, on a copy of the image
    (`utils/inference.py:188-206` of the JAX package; the reference uses
    supervision, `util/inference.py:82-97`). The boxes are drawn on the
    numpy array, clipped to the image. Each label ("phrase score") is
    written above its box with PIL where it is installed, and left out
    where it is not: the port has no font of its own."""
    img = np.ascontiguousarray(image_source, dtype=np.uint8).copy()
    h, w = img.shape[:2]
    corners = []
    for box in np.asarray(boxes, np.float64).reshape(-1, 4):
        cx, cy, bw, bh = box * [w, h, w, h]
        corners.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
        _draw_box(img, *corners[-1], color=(255, 0, 0), width=2)
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return img
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    for (x0, y0, _, _), score, phrase in zip(corners, logits, phrases):
        draw.text((x0, max(y0 - 12, 0)), f"{phrase} {score:.2f}", fill=(255, 0, 0))
    return np.asarray(pil)
