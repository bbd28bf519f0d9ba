"""Batch assembly, the port of the JAX package's `data/loader.py`: samples
-> fixed-shape numpy batch dicts (reference `detr_dataset_mapper.py:85-137`,
`groundingdino_dt.py:preprocess_image` + `prepare_targets`). Host threads
decode and augment; the batcher pads the images to a shared static bucket
and normalizes the boxes by each image's true (resized, unpadded) size, as
`prepare_targets` does (`groundingdino_dual_zero_rep_branch.py:614-627`).
Batches stay numpy: the trainer and the evaluator move them to the model's
device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ziragroundingdino_torch.config import DataConfig
from ziragroundingdino_torch.data.transforms import (
    Sample,
    eval_size,
    eval_transform,
    normalize,
    pad_to_bucket,
    pick_bucket,
    train_transform,
)
from ziragroundingdino_torch.parallel import dist
from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer, tokenize_captions


def boxes_to_normalized_cxcywh(boxes_xyxy: np.ndarray, h: int, w: int) -> np.ndarray:
    """xyxy absolute -> cxcywh normalized by (w, h)."""
    if boxes_xyxy.size == 0:
        return boxes_xyxy.reshape(0, 4)
    b = boxes_xyxy.astype(np.float32) / np.array([w, h, w, h], np.float32)
    cx = (b[:, 0] + b[:, 2]) / 2
    cy = (b[:, 1] + b[:, 3]) / 2
    bw = b[:, 2] - b[:, 0]
    bh = b[:, 3] - b[:, 1]
    return np.stack([cx, cy, bw, bh], -1)


def collate(
    samples: Sequence[Sample],
    captions: Sequence[str],
    tokenizer: WordPieceTokenizer,
    cfg: DataConfig,
    max_text_len: int = 256,
    max_categories: int = 90,
    train: bool = True,
    force_bucket: Optional[Tuple[int, int]] = None,
) -> Dict[str, np.ndarray]:
    """The fixed-shape batch dict of the train step and the evaluator:
    normalized f32 pixels padded to the largest of the samples' buckets (or
    `force_bucket`, which a sharded loader pins so that every shard has one
    shape), the text batch, and targets padded to `cfg.max_boxes`; eval
    batches add the crowd regions and the annotations' areas."""
    if force_bucket is not None:
        bh, bw = force_bucket
    else:
        buckets = [pick_bucket(s.image.shape[0], s.image.shape[1], cfg.shape_buckets)
                   for s in samples]
        bh = max(b[0] for b in buckets)
        bw = max(b[1] for b in buckets)

    b = len(samples)
    pixels = np.zeros((b, bh, bw, 3), np.float32)
    mask = np.zeros((b, bh, bw), bool)
    n_max = cfg.max_boxes
    gt_boxes = np.zeros((b, n_max, 4), np.float32)
    gt_labels = np.zeros((b, n_max), np.int32)
    gt_valid = np.zeros((b, n_max), bool)
    sizes = np.zeros((b, 2), np.int32)  # true (h, w) after resize
    orig_sizes = np.zeros((b, 2), np.int32)
    image_ids = np.zeros((b,), np.int64)
    if not train:
        # crowd ignore-regions, sized by the batch's largest count (they
        # never reach the model, so nothing is truncated)
        nc_max = max([len(s.crowd_boxes) for s in samples] + [1])
        crowd_boxes = np.zeros((b, nc_max, 4), np.float32)
        crowd_labels = np.zeros((b, nc_max), np.int32)
        crowd_valid = np.zeros((b, nc_max), bool)
        gt_areas = np.zeros((b, n_max), np.float32)  # 0 = the box area

    for i, s in enumerate(samples):
        pixels[i], mask[i] = pad_to_bucket(normalize(s.image, cfg), (bh, bw))
        h, w = s.image.shape[:2]
        sizes[i] = (h, w)
        orig_sizes[i] = s.orig_size
        image_ids[i] = s.image_id
        n = min(len(s.boxes), n_max)
        if n:
            gt_boxes[i, :n] = boxes_to_normalized_cxcywh(s.boxes[:n], h, w)
            gt_labels[i, :n] = s.labels[:n]
            gt_valid[i, :n] = True
        if not train:
            nc = len(s.crowd_boxes)
            if nc:
                crowd_boxes[i, :nc] = boxes_to_normalized_cxcywh(s.crowd_boxes[:nc], h, w)
                crowd_labels[i, :nc] = s.crowd_labels[:nc]
                crowd_valid[i, :nc] = True
            na = min(len(s.gt_areas), n_max)
            if na:
                gt_areas[i, :na] = s.gt_areas[:na]

    tb = tokenize_captions(tokenizer, list(captions), max_text_len=max_text_len,
                           max_categories=max_categories)
    batch = {
        "pixels": pixels,
        "mask": mask,
        "input_ids": tb.input_ids,
        "text_token_mask": tb.text_token_mask,
        "position_ids": tb.position_ids,
        "text_self_attention_masks": tb.text_self_attention_masks,
        "cate_to_token_mask": tb.cate_to_token_mask,
        "gt_labels": gt_labels,
        "gt_boxes": gt_boxes,
        "gt_valid": gt_valid,
        "sizes": sizes,
        "orig_sizes": orig_sizes,
        "image_ids": image_ids,
    }
    if not train:
        batch.update(crowd_boxes=crowd_boxes, crowd_labels=crowd_labels,
                     crowd_valid=crowd_valid, gt_areas=gt_areas)
    return batch


class DataLoader:
    """Endless (train) or single-pass (eval) loader with a thread-pool
    prefetch, the `num_workers` DataLoader of the reference
    (`aquarium.py:61-66`).

    Training draws the index stream from one `RandomState(seed)` and each
    sample's augmentation from a RandomState keyed on (batch counter,
    position in the global batch), so the stream does not depend on worker
    scheduling, and `start_batch=k` (index draws only, no decoding) gives
    batch k of an uninterrupted run: a mid-task resume sees the same data.
    `batch_size` is the global batch; with `shard_count` > 1 this loader
    yields shard `shard_rank`'s contiguous slice of every global batch
    (both default to the data axis's rank and size, `parallel.dist`, as
    the JAX package's take `jax.process_index()` / `process_count()`; the
    model and seq ranks of one replica load the same images).
    Eval pads the last batch with copies of its last sample and says how
    many are real in `real_count`; a shard's slice of it says how many of
    the slice are, and pads to the bucket of the whole global batch (the
    resized size follows from each image's recorded size), so that each
    image meets the padding it would meet in one process."""

    def __init__(
        self,
        dataset,  # CocoDataset
        tokenizer: WordPieceTokenizer,
        cfg: DataConfig,
        batch_size: int = 2,
        train: bool = True,
        seed: int = 42,
        max_text_len: int = 256,
        max_categories: int = 90,
        num_workers: Optional[int] = None,
        caption: Optional[str] = None,
        start_batch: int = 0,
        shard_rank: Optional[int] = None,
        shard_count: Optional[int] = None,
    ):
        shard_rank = dist.data_rank() if shard_rank is None else shard_rank
        shard_count = dist.data_size() if shard_count is None else shard_count
        if batch_size % shard_count:
            raise ValueError(f"global batch {batch_size} not divisible by {shard_count} shards")
        self.shard_rank, self.shard_count = shard_rank, shard_count
        self.ds = dataset
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.rng = np.random.RandomState(seed)  # the index stream only
        self.max_text_len = max_text_len
        self.max_categories = max_categories
        self.num_workers = cfg.num_workers if num_workers is None else num_workers
        self.caption = caption if caption is not None else dataset.caption
        self.start_batch = start_batch

    def _make_sample(self, idx: int, rng: Optional[np.random.RandomState] = None) -> Sample:
        s = self.ds.load_sample(idx)
        if self.train:
            return train_transform(s, self.cfg, rng if rng is not None else self.rng)
        return eval_transform(s, self.cfg)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._train_iter() if self.train else self._eval_iter()

    def _index_stream(self):
        """Global batches of indices, a permutation per epoch (every shard
        draws the same one); a dataset smaller than a batch is resampled
        with replacement."""
        n = len(self.ds)
        local = self.batch_size // self.shard_count
        lo, hi = self.shard_rank * local, (self.shard_rank + 1) * local
        while True:
            order = self.rng.permutation(n)
            if n < self.batch_size:
                order = self.rng.randint(0, n, size=self.batch_size)
            for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                yield order[start + lo: start + hi]

    def _train_iter(self):
        local = self.batch_size // self.shard_count
        base_pos = self.shard_rank * local

        def make_batch(job):
            bi, idxs = job

            def rng_for(k):
                return np.random.RandomState(
                    (self.seed + 0x9E3779B1 * (bi + 1) + 0x85EBCA6B * (base_pos + k + 1))
                    % (2**32))

            return collate(
                [self._make_sample(int(i), rng_for(k)) for k, i in enumerate(idxs)],
                [self.caption] * len(idxs), self.tokenizer, self.cfg, self.max_text_len,
                self.max_categories, train=True,
                force_bucket=self.cfg.shape_buckets[-1] if self.shard_count > 1 else None)

        jobs = enumerate(self._index_stream())
        for _ in range(self.start_batch):
            next(jobs)
        if self.num_workers > 0:
            yield from self._prefetched(make_batch, jobs)
            return
        for job in jobs:
            yield make_batch(job)

    def _prefetched(self, make_batch, jobs, depth: int = 4):
        """Worker threads build batches ahead of the loop (numpy and torch's
        CPU resize release the interpreter lock for the heavy parts);
        results come in submission order."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = [pool.submit(make_batch, next(jobs)) for _ in range(depth)]
            while True:
                fut = pending.pop(0)
                pending.append(pool.submit(make_batch, next(jobs)))
                yield fut.result()

    def _eval_iter(self):
        """This shard's slice of every global eval batch (the whole batch in
        one process), the last one padded with copies of the dataset's last
        sample (a slice of copies only has `real_count` 0), at the global
        batch's bucket."""
        n = len(self.ds)
        local = self.batch_size // self.shard_count
        lo = self.shard_rank * local
        for start in range(0, n, self.batch_size):
            idxs = [min(i, n - 1) for i in range(start, start + self.batch_size)]
            real = min(max(n - start - lo, 0), local)
            # collate's bucket of the global batch: the largest height and
            # width among its images' buckets
            buckets = [pick_bucket(*eval_size(self.ds.images[i]["height"],
                                              self.ds.images[i]["width"], self.cfg),
                                   self.cfg.shape_buckets) for i in idxs]
            bucket = (max(b[0] for b in buckets), max(b[1] for b in buckets))
            samples = [self._make_sample(i) for i in idxs[lo:lo + local]]
            batch = collate(samples, [self.caption] * local, self.tokenizer, self.cfg,
                            self.max_text_len, self.max_categories, train=False,
                            force_bucket=bucket)
            batch["real_count"] = np.asarray(real, np.int32)
            yield batch
