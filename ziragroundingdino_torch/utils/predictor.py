"""The serving predictor, the port of the JAX package's `utils/predictor.py`.

A persistent predictor that
  * routes each request to a static key (batch bucket, image bucket, text
    length bucket, category bucket), so that every key is prepared once and
    kept for the life of the process;
  * batches images that have their own captions in one device call;
  * returns per-image detections in original-image coordinates.

The JAX package compiles one program per key (`jax.jit`). On the card the
counterpart is one `torch.cuda.CUDAGraph` per key, captured once over static
input buffers: the forward and the post-processing (per-category logits,
top-k, scaling to the original size) replay as one graph, with no launch
from the host but the replay. A request copies its host arrays into the
key's buffers through pinned staging, replays the graph and copies the
[B, select_k] results back with one sync. All graphs share one memory pool
(`torch.cuda.graph_pool_handle()`); a graph sharing the pool may overwrite
another's outputs when it replays, so each request copies its outputs out
before it returns. On the CPU (the tests) the same code runs the forward
eagerly over the same buffers. A capture that fails raises; nothing falls
back to eager on the card.

Each graph holds the boundaries of the forward's `PARTS` as timing events
(`utils/profiling.py::parts`), which every replay records: while a
profiler records, a request's `predictor.run` span gets one child a part,
`predictor.run.<part>`, with the stream time between its events (host time
on the CPU).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ziragroundingdino_torch.config import DataConfig
from ziragroundingdino_torch.data.transforms import (
    Sample,
    eval_transform,
    pad_to_bucket,
    pick_bucket,
)
from ziragroundingdino_torch.eval.postprocess import scale_to_original, top_k_detections
from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.text.masks import recover_to_cls_logits
from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer, tokenize_captions
from ziragroundingdino_torch.utils import profiling

logger = logging.getLogger("ziragroundingdino_torch")

WARMUP_RUNS = 2  # eager runs on a side stream before a capture: lazy set-up, Swin's tables
# the parts of a forward (`profiling.parts`, `mark`) that `predictor.run`'s
# children `predictor.run.<part>` time: the pixels' normalisation, BERT,
# feat_map and the language branch; Swin, the level projections, masks and
# positions, flattened; the feature enhancer; query selection, the decoder,
# the heads and the post-processing
PARTS = ("text", "backbone", "encoder", "decoder")
_TEXT_KEYS = ("input_ids", "text_token_mask", "position_ids", "text_self_attention_masks")


@dataclass
class _Program:
    """What one key keeps: its static inputs on the device and the host
    tensors they are filled from; on the card also the graph, the outputs
    it writes (scores, labels, boxes, each [B, select_k]) and the pinned
    host tensors they are copied back into."""

    inputs: Dict[str, torch.Tensor]
    staging: Dict[str, torch.Tensor]
    graph: Optional["torch.cuda.CUDAGraph"] = None
    outputs: Tuple[torch.Tensor, ...] = ()
    results: Tuple[torch.Tensor, ...] = ()
    parts: Optional[profiling.Parts] = None  # the graph's part boundaries


class Predictor:
    """`Predictor(model, tokenizer)(images, class_lists, score_threshold)`:
    see the module doc. `model` is a built `GroundingDINO` in eval mode on
    its device; images are uint8 HWC RGB arrays of any size."""

    def __init__(
        self,
        model: GroundingDINO,
        tokenizer: WordPieceTokenizer,
        data_cfg: Optional[DataConfig] = None,
        select_k: int = 200,
        text_len_buckets: Sequence[int] = (32, 64, 128, 256),
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        category_buckets: Sequence[int] = (4, 8, 16, 32, 90),
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.dcfg = data_cfg or DataConfig()
        self.select_k = select_k
        self.text_len_buckets = tuple(text_len_buckets)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.category_buckets = tuple(sorted(category_buckets))
        self.device = next(model.parameters()).device
        self._compiled: Dict[Tuple, _Program] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

    # ------------------------------------------------------------------
    def _detect(self, pixels, mask, text, c2t, orig_sizes):
        """The forward and the post-processing of one key: (scores, labels,
        boxes xyxy in original pixels), each [B, select_k]."""
        out = self.model(pixels, mask, text)
        t = c2t.shape[-1]
        cls_logits = recover_to_cls_logits(out["pred_logits"][..., :t], c2t, fill=-100.0)
        det = top_k_detections(cls_logits, out["pred_boxes"], k=self.select_k)
        boxes = scale_to_original(det["boxes_cxcywh"], orig_sizes)
        return det["scores"], det["labels"], boxes

    def _run(self, prog: _Program):
        i = prog.inputs
        return self._detect(i["pixels"], i["mask"], {k: i[k] for k in _TEXT_KEYS},
                            i["cate_to_token_mask"], i["orig_sizes"])

    def _program(self, key: Tuple, host: Dict[str, np.ndarray]) -> _Program:
        """The key's program, prepared on its first request (whose arrays
        fill the buffers for the warm-up and the capture)."""
        prog = self._compiled.get(key)
        if prog is not None:
            return prog
        logger.info("predictor: preparing bucket %s", key)
        with profiling.span("predictor.capture", stream=False):
            prog = self._prepare(host)
        self._compiled[key] = prog
        return prog

    def _prepare(self, host: Dict[str, np.ndarray]) -> _Program:
        """A new key's buffers and, on the card, its warm-up and capture."""
        pin = self.device.type == "cuda"
        staging = {k: torch.from_numpy(np.ascontiguousarray(v)).clone() for k, v in host.items()}
        if pin:
            staging = {k: v.pin_memory() for k, v in staging.items()}
        inputs = {k: v.to(self.device) for k, v in staging.items()}
        prog = _Program(inputs=inputs, staging=staging)
        if not pin:
            return prog
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._run(prog)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            with profiling.parts(PARTS[0], self.device) as prog.parts:
                prog.outputs = self._run(prog)
        prog.graph = graph
        prog.results = tuple(torch.empty(o.shape, dtype=o.dtype).pin_memory()
                             for o in prog.outputs)
        return prog

    def _pad_batch(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    # ------------------------------------------------------------------
    def __call__(
        self,
        images: Sequence[np.ndarray],  # uint8 HWC RGB
        class_lists: Sequence[Sequence[str]],
        score_threshold: float = 0.3,
    ) -> List[Dict[str, np.ndarray]]:
        """Per image: `boxes` [K, 4] xyxy in original pixels, `scores` [K],
        `labels` [K] and `label_names` of the detections scoring above
        `score_threshold`, best first."""
        if len(images) != len(class_lists):
            raise ValueError(f"{len(images)} images but {len(class_lists)} class lists")
        n = len(images)
        max_b = self.batch_buckets[-1]
        if n > max_b:  # split oversized requests across device calls
            out: List[Dict[str, np.ndarray]] = []
            for i in range(0, n, max_b):
                out.extend(self(images[i:i + max_b], class_lists[i:i + max_b],
                                score_threshold))
            return out
        bsz = self._pad_batch(n)
        with profiling.span("predictor.request", stream=False,
                            images=n, batch=bsz) as req:
            return self._request(images, class_lists, score_threshold, bsz, req)

    def _request(self, images, class_lists, score_threshold, bsz, req
                 ) -> List[Dict[str, np.ndarray]]:
        """One device call: `images` (at most the largest batch bucket) in
        batch bucket `bsz`; `req` is the request's span."""
        n = len(images)
        with profiling.span("predictor.resize", stream=False):
            samples = []
            for img in images:
                s = Sample(image=np.asarray(img), boxes=np.zeros((0, 4), np.float32),
                           labels=np.zeros((0,), np.int64), orig_size=img.shape[:2])
                samples.append(eval_transform(s, self.dcfg))
        with profiling.span("predictor.pad", stream=False):
            # the largest height and width of the images' buckets, as
            # `data/loader.py::collate` pads a batch: a landscape and a
            # portrait image share one padded shape
            buckets = [pick_bucket(s.image.shape[0], s.image.shape[1], self.dcfg.shape_buckets)
                       for s in samples]
            bucket = (max(b[0] for b in buckets), max(b[1] for b in buckets))
            # uint8 pixels, normalised on the device (the model's uint8 path)
            pixels = np.zeros((bsz, *bucket, 3), np.uint8)
            mask = np.zeros((bsz, *bucket), bool)
            orig = np.zeros((bsz, 2), np.int32)
            for i, s in enumerate(samples):
                pixels[i], mask[i] = pad_to_bucket(s.image.astype(np.uint8), bucket)
                orig[i] = s.orig_size
            for i in range(n, bsz):  # repeat-pad
                pixels[i], mask[i], orig[i] = pixels[n - 1], mask[n - 1], orig[n - 1]

        with profiling.span("predictor.tokenize", stream=False):
            captions = [".".join(c.lower().strip() for c in cl) + "." for cl in class_lists]
            captions += [captions[-1]] * (bsz - n)
            need_c = max(max(len(cl) for cl in class_lists), 1)
            max_c = next((b for b in self.category_buckets if b >= need_c),
                         self.category_buckets[-1])
            tb = tokenize_captions(self.tokenizer, captions,
                                   max_text_len=self.text_len_buckets[-1],
                                   max_categories=max_c, text_len_buckets=self.text_len_buckets)
        if req.recording:
            req.count(pixels_real=sum(s.image.shape[0] * s.image.shape[1] for s in samples),
                      pixels_padded=bsz * bucket[0] * bucket[1],
                      tokens_real=int(tb.text_token_mask[:n].sum()),
                      tokens_padded=bsz * tb.input_ids.shape[1])

        key = (bsz, bucket, tb.input_ids.shape[1], max_c)
        host = dict(tb.asdict(), pixels=pixels, mask=mask,
                    cate_to_token_mask=tb.cate_to_token_mask, orig_sizes=orig)
        with torch.inference_mode():
            prog = self._program(key, host)
            if prog.graph is None:
                with profiling.span("predictor.stage", stream=False):
                    for k, v in host.items():
                        prog.inputs[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
                with profiling.span("predictor.run"):
                    with profiling.parts(PARTS[0], self.device) as parts:
                        out = self._run(prog)
                    parts.record("predictor.run")
                    scores, labels, boxes = (t.numpy() for t in out)
            else:
                with profiling.span("predictor.stage", stream=False):
                    for k, v in host.items():
                        prog.staging[k].numpy()[...] = v
                        prog.inputs[k].copy_(prog.staging[k], non_blocking=True)
                with profiling.span("predictor.run"):
                    prog.graph.replay()
                    for host_out, out in zip(prog.results, prog.outputs):
                        host_out.copy_(out, non_blocking=True)
                    torch.cuda.current_stream(self.device).synchronize()
                    prog.parts.record("predictor.run")
                    scores, labels, boxes = (t.numpy() for t in prog.results)

        with profiling.span("predictor.results", stream=False):
            results = []
            for i in range(n):
                keep = scores[i] > score_threshold
                names = list(class_lists[i])
                results.append({
                    "boxes": boxes[i][keep],
                    "scores": scores[i][keep],
                    "labels": labels[i][keep],
                    "label_names": [names[j] if j < len(names) else f"cls{j}"
                                    for j in labels[i][keep]],
                })
        return results
