"""Serving cells: the port's `Predictor` in a closed loop, one client.

Set-up builds the model from the seed's weights, wraps it in a `Recorder`,
builds the `Predictor` and warms the keys of the cell's traffic (one call
per key: the Predictor warms and captures a key on its first request).
Set-up then sends one whole cycle at the window's pace. The window sends
the cycle's requests one after another for
`--seconds`; each call is timed on the host from the call until its
outputs are on the host (the Predictor returns after a synchronise).

`Recorder` is the benchmark's instrument inside the timed path: it copies
the model's `topk_idx`, `pred_logits` and `pred_boxes` into static buffers
on every call, so the copies are captured into each key's CUDA graph (one
device copy of ~1-2 MB a request). After a sampled request the buffers are
copied into one of the slots set aside in set-up. The check then follows the program's own query
selection (see `benchmark/lib/compare.py`).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from benchmark.lib import program, traffic
from benchmark.reference import data as rdata
from benchmark.reference import text as rtext


def _bucket(n: int, buckets) -> int:
    return next((b for b in sorted(buckets) if n <= b), sorted(buckets)[-1])


KEYS = ("topk_idx", "pred_logits", "pred_boxes", "memory", "memory_text")


class Recorder(nn.Module):
    """The model, plus a copy of what the check reads into static buffers,
    and `slots` buffers as many to keep the sampled requests' copies in (set
    aside in set-up: the window allocates nothing for them). The encoder's
    output (image memory and text) is copied by a forward hook on the
    encoder, run while each key is captured, so the copy is in the graph;
    the memory buffer holds the largest bucket's tokens, a request's own
    first."""

    def __init__(self, model: nn.Module, batch: int, slots: int, tokens: int, device):
        super().__init__()
        self.model = model
        cfg = model.cfg
        q, t, e = cfg.num_queries, cfg.max_text_len, cfg.hidden_dim
        cd = cfg.torch_dtype

        def buffers(*lead):
            return {"topk_idx": torch.zeros(*lead, batch, q, dtype=torch.long, device=device),
                    "pred_logits": torch.zeros(*lead, batch, q, t, device=device),
                    "pred_boxes": torch.zeros(*lead, batch, q, 4, device=device),
                    "memory": torch.zeros(*lead, batch, tokens, e, dtype=cd, device=device),
                    "memory_text": torch.zeros(*lead, batch, t, e, dtype=cd, device=device)}

        self.now = buffers()
        self.kept = buffers(slots)
        model.transformer.encoder.register_forward_hook(self._encoder_out)

    def _encoder_out(self, mod, args, out):
        src, text = out[0], out[1]
        self.now["memory"][:, :src.shape[1]].copy_(src)
        self.now["memory_text"][:, :text.shape[1]].copy_(text)

    def forward(self, pixels, mask, text):
        out = self.model(pixels, mask, text)
        for k in KEYS[:3]:
            self.now[k].copy_(out[k])
        return out

    def keep(self, slot: int) -> None:
        for k in KEYS:
            self.kept[k][slot].copy_(self.now[k])

    def kept_copy(self, slot: int) -> Dict[str, torch.Tensor]:
        return {k: self.kept[k][slot].cpu() for k in KEYS}


@dataclass
class Sample:
    index: int  # position in the window
    request: traffic.Request
    recorded: object  # the Recorder's slot, then (after `free`) its tensors on the host
    results: List[Dict[str, np.ndarray]]


@dataclass
class ServeRun:
    conf: Dict
    mix: Dict
    seed: int
    device: torch.device
    latencies: List[float] = field(default_factory=list)
    images: int = 0
    window_s: float = 0.0
    samples: List[Sample] = field(default_factory=list)
    keys_before: int = 0
    keys_after: int = 0
    phases: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------------ set-up
    def setup(self, state: Dict[str, torch.Tensor]) -> None:
        from ziragroundingdino_torch.config import DataConfig
        from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer
        from ziragroundingdino_torch.utils.predictor import Predictor

        t = time.perf_counter()
        p = self.mix["predictor"]
        self.vocab = rtext.make_vocab(traffic.vocab_words(self.mix))
        self.dcfg = DataConfig(**{k: (tuple(tuple(b) for b in v) if k == "shape_buckets" else v)
                                  for k, v in self.mix.get("data", {}).items()})
        self.bsz = _bucket(self.mix["batch"], p["batch_buckets"])
        self.model = program.build(self.conf, state, self.device)
        tokens = max(level_tokens(self.conf, b) for b in self.dcfg.shape_buckets)
        self.recorder = Recorder(self.model, self.bsz, self.mix["check"]["requests"], tokens,
                                 self.device)
        self.predictor = Predictor(self.model, WordPieceTokenizer(self.vocab), self.dcfg,
                                   select_k=p["select_k"],
                                   text_len_buckets=p["text_len_buckets"],
                                   batch_buckets=p["batch_buckets"],
                                   category_buckets=p["category_buckets"])
        self.predictor.model = self.recorder
        self.phases["model"] = time.perf_counter() - t
        self.cycle = traffic.serve_cycle(self.mix, self.seed, self.device)
        self.phases["traffic"] = time.perf_counter() - t - self.phases["model"]
        seen = set()
        for req in self.cycle:
            key = self.key(req)
            if key not in seen:
                seen.add(key)
                self.call(req)
        self.keys = seen
        for req in self.cycle:  # one whole cycle at the window's pace, before it
            self.call(req)
        self.keys_before = self.captured()
        self.phases["warm-up"] = time.perf_counter() - t - self.phases["model"] \
            - self.phases["traffic"]

    def key(self, req: traffic.Request):
        """The Predictor's key of a request, by the benchmark's own arithmetic:
        (batch bucket, image bucket, text bucket, category bucket)."""
        p = self.mix["predictor"]
        sizes = [rdata.shortest_edge_size(im.shape[0], im.shape[1], self.dcfg.test_short_side,
                                          self.dcfg.max_size) for im in req.images]
        bucket = max((rdata.pick_bucket(h, w, self.dcfg.shape_buckets) for h, w in sizes),
                     key=lambda b: b[0] * b[1])
        tokens = max(len(rtext.encode(self.vocab, rtext.caption(l))) for l in req.labels)
        return (self.bsz, bucket, _bucket(tokens, p["text_len_buckets"]),
                _bucket(max(len(l) for l in req.labels), p["category_buckets"]))

    def captured(self) -> int:
        """The Predictor's prepared keys (its own count)."""
        return len(self.predictor._compiled)

    def call(self, req: traffic.Request):
        return self.predictor(req.images, req.labels,
                              score_threshold=self.mix["predictor"]["score_threshold"])

    # ------------------------------------------------------------------ window
    def window(self, seconds: float, tracer=None) -> None:
        n_check = self.mix["check"]["requests"]
        rng = np.random.default_rng([self.seed, 7])
        longest = max(r.longest for r in self.cycle)
        slots: List[Optional[Sample]] = [None] * n_check
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            req = self.cycle[i % len(self.cycle)]
            if tracer is not None:
                tracer.begin(i, req)
            t = time.perf_counter()
            results = self.call(req)
            done = time.perf_counter()
            if tracer is not None:
                tracer.end(i)
            self.latencies.append((done - t) * 1e3)
            self.images += len(req.images)
            # slot 0: the latest of the requests with the most labels; the
            # others a reservoir sample of every request of the window
            pick = None
            if req.longest == longest:
                pick = 0
            elif n_check > 1:
                j = int(rng.integers(0, i + 1))
                if j < n_check - 1:
                    pick = j + 1
            if pick is not None:
                self.recorder.keep(pick)
                slots[pick] = Sample(i, req, pick, results)
            i += 1
            if done >= deadline:
                break
        self.window_s = done - t0
        self.samples = [s for s in slots if s is not None]
        self.keys_after = self.captured()

    def metrics(self) -> Dict[str, float]:
        lat = self.latencies
        print(f"window: {len(lat)} requests; first 20 mean {np.mean(lat[:20]):.2f} ms, the rest "
              f"median {np.median(lat[20:]):.2f} ms; p95 {np.percentile(lat, 95):.2f} ms",
              file=sys.stderr)
        return {"serve_img_per_s": self.images / self.window_s}

    def attempted(self) -> int:
        return len(self.latencies)

    def failed(self) -> int:
        return 0  # a call that raises ends the run

    def flops_keys(self, req: traffic.Request):
        """(h, w, T) of each image of a request at its resized size and
        real token count: what its model FLOPs are counted at."""
        out = []
        for im, labels in zip(req.images, req.labels):
            h, w = rdata.shortest_edge_size(im.shape[0], im.shape[1],
                                            self.dcfg.test_short_side, self.dcfg.max_size)
            out.append((h, w, len(rtext.encode(self.vocab, rtext.caption(labels)))))
        return out

    def device_shape(self, req: traffic.Request):
        """(batch, H, W) the request's graph runs at."""
        key = self.key(req)
        return key[0], key[1][0], key[1][1]

    def free(self) -> None:
        for s in self.samples:
            s.recorded = self.recorder.kept_copy(s.recorded)
        del self.predictor, self.recorder, self.model

    # ------------------------------------------------------------------ check
    def reference_inputs(self, req: traffic.Request):
        """What the reference works out again from the request: resized and
        padded pixels, masks, token ids and caption masks, original sizes."""
        p = self.mix["predictor"]
        imgs = [rdata.eval_resize(im, self.dcfg.test_short_side, self.dcfg.max_size)
                for im in req.images]
        bucket = max((rdata.pick_bucket(im.shape[0], im.shape[1], self.dcfg.shape_buckets)
                      for im in imgs), key=lambda b: b[0] * b[1])
        n = len(imgs)
        imgs += [imgs[-1]] * (self.bsz - n)
        px, mask = rdata.pad_batch(imgs, bucket)
        caps = [rtext.caption(l) for l in req.labels]
        caps += [caps[-1]] * (self.bsz - n)
        cat_b = _bucket(max(len(l) for l in req.labels), p["category_buckets"])
        tb = rtext.text_batch(self.vocab, caps, p["text_len_buckets"],
                              max_text_len=p["text_len_buckets"][-1], max_categories=cat_b)
        orig = [im.shape[:2] for im in req.images]
        orig += [orig[-1]] * (self.bsz - n)
        dev = self.device
        text = {k: torch.from_numpy(v).to(dev) for k, v in tb.items()}
        return (torch.from_numpy(px).to(dev), torch.from_numpy(mask).to(dev), text,
                torch.tensor(orig, device=dev), n)


def level_tokens(conf: Dict, bucket) -> int:
    """The encoder's tokens of a configuration at an image bucket."""
    from benchmark.lib.counts import conf_level_shapes

    return sum(h * w for h, w in conf_level_shapes(conf, *bucket))
