"""User-facing inference API, the port of the JAX package's `utils/
inference.py` (reference `util/inference.py:24-97` and the demo's phrase
extraction, `util/utils.py:598`): `load_model`, `load_image`, `predict`,
`predict_classes`, `get_phrases_from_posmap` and `annotate`.

    lm = load_model("groundingdino_swint_ogc.pth", "vocab.txt")
    image, (pixels, mask), size = load_image("cat.ppm")
    boxes, logits, phrases = predict(lm, pixels, mask, "cat . dog .")

Every forward runs under `torch.inference_mode()` on the model's device.
`load_image` reads, resizes, normalizes and pads an image to a bucket.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ziragroundingdino_torch.config import GroundingDINOConfig
from ziragroundingdino_torch.data.transforms import load_image  # noqa: F401  (part of this API)
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
    """The outline of [x0, x1] x [y0, y1] (pixel coordinates) as Pillow's
    `ImageDraw.rectangle(outline=, width=)` draws it, clipped to the image,
    in place: the corners truncated toward zero; for each i < width the
    rows y0 + i and y1 - i from x0 to x1, and the columns x0 + i and
    x1 - i from row y0 + width toward row y1 - width + 1, that row left out
    (in a box thinner than 2 * width the columns run upward, past it)."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))
    left, right = max(x0, 0), min(x1, w - 1)
    for i in range(width):
        for y in (y0 + i, y1 - i):
            if 0 <= y < h and left <= right:
                img[y, left:right + 1] = color
        start, stop = y0 + width, y1 - width + 1
        rows = range(start, stop) if stop >= start else range(stop + 1, start + 1)
        top, bottom = max(rows.start, 0), min(rows.stop, h)
        for x in (x0 + i, x1 - i):
            if 0 <= x < w and top < bottom:
                img[top:bottom, x] = color


def draw_boxes(image_source: np.ndarray, corners: Sequence[Tuple[float, float, float, float]],
               labels: Sequence[str]) -> np.ndarray:
    """Each box (xyxy, pixels) drawn in red, 2 pixels wide, on a copy of the
    image, on the numpy array and clipped to it; each label written above
    its box with PIL where it is installed, and left out where it is not
    (the port has no font of its own)."""
    img = np.ascontiguousarray(image_source, dtype=np.uint8).copy()
    for c in corners:
        _draw_box(img, *c, color=(255, 0, 0), width=2)
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return img
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    for (x0, y0, _, _), label in zip(corners, labels):
        draw.text((x0, max(y0 - 12, 0)), label, fill=(255, 0, 0))
    return np.asarray(pil)


def annotate(
    image_source: np.ndarray,  # [H, W, 3] uint8
    boxes: np.ndarray,  # [N, 4] cxcywh normalized
    logits: np.ndarray,
    phrases: List[str],
) -> np.ndarray:
    """Draw each box and its label ("phrase score") with `draw_boxes`
    (`utils/inference.py:188-206` of the JAX package; the reference uses
    supervision, `util/inference.py:82-97`)."""
    h, w = np.asarray(image_source).shape[:2]
    corners = []
    for box in np.asarray(boxes, np.float64).reshape(-1, 4):
        cx, cy, bw, bh = box * [w, h, w, h]
        corners.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
    return draw_boxes(image_source, corners,
                      [f"{phrase} {score:.2f}" for score, phrase in zip(logits, phrases)])
