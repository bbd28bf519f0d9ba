"""Dataset evaluation, the port of the JAX package's `eval/evaluator.py`
(reference `inference_on_dataset`, `evaluation/evaluator.py:82-158`, and
`COCOEvaluator`, `evaluation/coco_evaluation.py:25-269`): detections of
every batch into the numpy `CocoMeanAP`, and the time per image without the
warm-up batches."""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ziragroundingdino_torch.eval.coco_map import CocoMeanAP
from ziragroundingdino_torch.eval.postprocess import scale_to_original, top_k_detections
from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.parallel import dist
from ziragroundingdino_torch.text.masks import recover_to_cls_logits

logger = logging.getLogger(__name__)

MODEL_KEYS = ("pixels", "mask", "input_ids", "text_token_mask", "position_ids",
              "text_self_attention_masks", "cate_to_token_mask", "orig_sizes")


def make_inference_fn(model: GroundingDINO, select_k: int = 200
                      ) -> Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]:
    """(numpy batch) -> detections in original-image pixels, on the model's
    device: the batch is copied there and the model runs in eval mode
    without autograd, with whatever weights it holds at the call."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def fn(batch):
        model.eval()
        b = {k: torch.as_tensor(batch[k]).to(device) for k in MODEL_KEYS}
        text = {k: b[k] for k in ("input_ids", "text_token_mask", "position_ids",
                                  "text_self_attention_masks")}
        out = model(b["pixels"], b["mask"], text)
        c2t = b["cate_to_token_mask"]
        cls_logits = recover_to_cls_logits(out["pred_logits"][..., :c2t.shape[-1]], c2t,
                                           fill=-100.0)
        det = top_k_detections(cls_logits, out["pred_boxes"], k=select_k)
        return {"scores": det["scores"], "labels": det["labels"],
                "boxes": scale_to_original(det["boxes_cxcywh"], b["orig_sizes"])}

    return fn


def _denorm(g: np.ndarray, orig_hw) -> np.ndarray:
    """Normalized cxcywh (by the resized size) -> absolute xyxy in the
    original frame."""
    if not g.size:
        return np.zeros((0, 4), np.float32)
    cx, cy, w, h = g.T
    gx = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    oh, ow = orig_hw
    return gx * np.array([ow, oh, ow, oh], np.float32)


def inference_on_dataset(
    loader: Iterable[Dict[str, np.ndarray]],
    inference_fn: Callable,
    num_classes: int,
    num_warmup: int = 2,
    score_floor: float = 0.0,
    class_names: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """COCO metrics of `inference_fn`'s detections over the loader's eval
    batches, and `sec_per_img` / `images_per_sec`: the time of
    `inference_fn` (host-to-device copy, forward, top-k; the card
    synchronised) over the images after the first `num_warmup` batches.

    Under data parallelism the loader yields this rank's slice of every
    global batch (`data.loader.DataLoader`); data rank 0 gathers every data
    rank's images, puts them back in the global order and scores them, so
    the metrics are the one-process run's, and every rank returns them (the
    model and seq ranks of a replica run the same images with it). The
    time is then the slowest rank's, over every rank's images
    (`parallel/sharded_eval.py` of the JAX package: the reference's DDP
    eval with all-gathered predictions, `util/misc.py:173-217`)."""
    images = []  # per batch, the evaluator's arguments of each real image
    compute_time = 0.0
    timed_images = 0
    for it, batch in enumerate(loader):
        real = int(batch.pop("real_count", len(batch["pixels"])))
        t0 = time.perf_counter()
        det = inference_fn(batch)
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in det.values()):
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if it >= num_warmup:
            compute_time += dt
            timed_images += real
        scores, labels, boxes = (np.asarray(torch.as_tensor(det[k]).cpu())[:real]
                                 for k in ("scores", "labels", "boxes"))
        rows = []
        for i in range(real):
            keep = scores[i] > score_floor
            v = batch["gt_valid"][i]
            orig = batch["orig_sizes"][i]
            extra = {}
            if "crowd_boxes" in batch:
                cv = batch["crowd_valid"][i]
                extra = dict(crowd_boxes=_denorm(batch["crowd_boxes"][i][cv], orig),
                             crowd_labels=batch["crowd_labels"][i][cv])
            if "gt_areas" in batch:
                extra["gt_areas"] = batch["gt_areas"][i][v]
            rows.append(((int(batch["image_ids"][i]), boxes[i][keep], scores[i][keep],
                          labels[i][keep], _denorm(batch["gt_boxes"][i][v], orig),
                          batch["gt_labels"][i][v]), extra))
        images.append(rows)

    res = None
    ranks = dist.gather_to_rank0((images, compute_time, timed_images))
    if ranks is not None:
        evaluator = CocoMeanAP(num_classes=num_classes)
        n_images = 0
        for per_rank in zip(*(r[0] for r in ranks)):  # batch by batch, rank by rank
            for rows in per_rank:
                for args, extra in rows:
                    evaluator.add(*args, **extra)
                    n_images += 1
        compute_time = max(r[1] for r in ranks)
        timed_images = sum(r[2] for r in ranks)
        res = evaluator.summarize()
        res["n_images"] = float(n_images)
        if timed_images:
            res["sec_per_img"] = compute_time / timed_images
            res["images_per_sec"] = timed_images / compute_time
        if class_names is not None:
            logger.info("per-category AP:\n%s", evaluator.per_category_table(class_names))
            res["per_category_AP"] = {n: float(v)
                                      for n, v in zip(class_names, evaluator.per_category_ap())}
    return dist.broadcast_object(res)
