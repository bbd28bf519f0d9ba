"""Training cells: the port's `train_step` on a fixed cycle of seeded batches.

Set-up builds one model and one `Optimizer` (the preset's trainable tensors,
AdamW, clip, lr factors, schedule from the configuration file), makes the
cycle's batches with the port's own `collate` (the loader's, so the step
gets what the loader gives it) and moves them to the card, then drives
that same model through its first steps: steps 1-3 are the check's (the
model's `topk_idx` of each is recorded by a forward hook and the matcher's
assignments by a wrapper around the criterion's `match_batch`, the trainable
tensors are copied before step 1 and after step 3, and AdamW's first moment
after step 1), the rest of the cycle's batches warm their shapes. The
window then goes on stepping through the cycle; each step draws its
dropout from a card generator seeded per iteration as the `Trainer` does;
the window ends on a synchronise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import program, traffic
from benchmark.reference import data as rdata
from benchmark.reference import text as rtext


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of iteration `it`, seeded from (seed, it) as the
    port's `Trainer` seeds it."""
    state = np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


@dataclass
class TrainRun:
    conf: Dict
    mix: Dict
    seed: int
    device: torch.device
    steps: int = 0
    images: int = 0
    window_s: float = 0.0
    check: Dict = field(default_factory=dict)
    window_losses: List = field(default_factory=list)
    phases: Dict[str, float] = field(default_factory=dict)

    def setup(self, state: Dict[str, torch.Tensor]) -> None:
        from ziragroundingdino_torch.config import DataConfig, OptimizerConfig, ScheduleConfig
        from ziragroundingdino_torch.train.optim import Optimizer, set_trainable

        t = time.perf_counter()
        tc = self.conf["train"]
        self.model = program.build(self.conf, state, self.device, remat=tc["remat"])
        set_trainable(self.model, tc["trainable"])
        self.model.train()
        o, s = tc["optimizer"], tc["schedule"]
        self.opt = Optimizer(
            self.model,
            OptimizerConfig(lr=o["lr"], weight_decay=o["weight_decay"], betas=tuple(o["betas"]),
                            grad_clip=o["grad_clip"],
                            lr_factors=tuple(tuple(x) for x in o["lr_factors"])),
            ScheduleConfig(max_iter=s["max_iter"], milestones_frac=tuple(s["milestones_frac"]),
                           gamma=s["gamma"]))
        self.vocab = rtext.make_vocab(traffic.vocab_words(self.mix))
        self.dcfg = DataConfig(shape_buckets=tuple(tuple(b) for b in self.mix["shape_buckets"]),
                               max_size=self.mix["max_size"], max_boxes=self.mix["max_boxes"])
        self.phases["model"] = time.perf_counter() - t
        self.cycle = traffic.train_cycle(self.mix, self.seed, self.device)
        self.phases["traffic"] = time.perf_counter() - t - sum(self.phases.values())
        self.batches = [self.port_batch(b) for b in self.cycle]
        self.phases["collate"] = time.perf_counter() - t - sum(self.phases.values())
        self.it = 0
        self.names = list(self.opt.params)
        n_check = self.mix["check"]["steps"]
        topk: List[torch.Tensor] = []
        matched: List[torch.Tensor] = []
        hook = self.model.register_forward_hook(
            lambda mod, args, out: topk.append(out["topk_idx"].detach().clone()))
        # the criterion's one matcher call a step: its assignments are recorded
        import ziragroundingdino_torch.train.criterion as criterion

        match_batch = criterion.match_batch

        def recorded(*args, **kwargs):
            out = match_batch(*args, **kwargs)
            matched.append(out.detach().clone())
            return out

        criterion.match_batch = recorded
        before = {n: p.detach().clone() for n, p in self.opt.params.items()}
        losses = []
        for k in range(n_check):
            losses.append(self.step()["total_loss"].detach().clone())
            if k == 0:
                b1 = self.opt.adamw.defaults["betas"][0]
                st = self.opt.adamw.state
                grads = {n: (st[p]["exp_avg"] / (1 - b1)).clone() if "exp_avg" in st.get(p, {})
                         else torch.zeros_like(p) for n, p in self.opt.params.items()}
        hook.remove()
        criterion.match_batch = match_batch
        self.phases["check steps"] = time.perf_counter() - t - sum(self.phases.values())
        after = {n: p.detach().clone() for n, p in self.opt.params.items()}
        self.check = {"losses": losses, "grads": grads, "topk": topk, "matched": matched,
                      "change": {n: after[n] - before[n] for n in before}}
        while self.it < len(self.batches):  # the cycle's other shapes
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases["warm steps"] = time.perf_counter() - t - sum(self.phases.values())

    def port_batch(self, images: List[traffic.TrainImage]) -> Dict[str, torch.Tensor]:
        from ziragroundingdino_torch.data.loader import collate
        from ziragroundingdino_torch.data.transforms import Sample
        from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer

        samples = [Sample(image=t.image, boxes=t.boxes_xyxy, labels=t.labels,
                          orig_size=t.image.shape[:2]) for t in images]
        caps = [traffic.caption(t.names) for t in images]
        b = collate(samples, caps, WordPieceTokenizer(self.vocab), self.dcfg,
                    max_text_len=self.mix["text_len_buckets"][-1],
                    max_categories=self.mix["max_categories"], train=True)
        keys = ("pixels", "mask", "input_ids", "text_token_mask", "position_ids",
                "text_self_attention_masks", "cate_to_token_mask", "gt_labels", "gt_boxes",
                "gt_valid")
        return {k: torch.from_numpy(np.ascontiguousarray(b[k])).to(self.device) for k in keys}

    def step(self):
        from ziragroundingdino_torch.train.step import train_step

        batch = self.batches[self.it % len(self.batches)]
        gen = iteration_generator(self.seed, self.it, self.device)
        out = train_step(self.model, self.opt, batch, generator=gen,
                         matcher_impl=self.conf["train"]["matcher"])
        self.it += 1
        self.steps += 1
        self.images += batch["pixels"].shape[0]
        return out

    def window(self, seconds: float, tracer=None) -> None:
        self.steps = self.images = 0
        sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" \
            else (lambda: None)
        sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.window_losses = []
        while time.perf_counter() < deadline:
            if tracer is not None:
                tracer.begin(self.it, self.it % len(self.batches))
            self.window_losses.append(self.step()["total_loss"])
            if tracer is not None:
                tracer.end(self.it - 1)
        sync()
        self.window_s = time.perf_counter() - t0

    def metrics(self) -> Dict[str, float]:
        return {"train_img_per_s": self.images / self.window_s}

    def attempted(self) -> int:
        return self.steps

    def failed(self) -> int:
        """Steps of the window whose total loss is not finite."""
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def flops_keys(self, index: int):
        """(h, w, T) of each image of a cycle batch at its training size and
        real token count."""
        return [(t.image.shape[0], t.image.shape[1],
                 len(rtext.encode(self.vocab, traffic.caption(t.names))))
                for t in self.cycle[index]]

    def device_shape(self, index: int):
        """(batch, H, W) of a cycle batch as the step runs it (padded to the
        largest of its images' buckets)."""
        images = self.cycle[index]
        buckets = [rdata.pick_bucket(t.image.shape[0], t.image.shape[1],
                                     [tuple(b) for b in self.mix["shape_buckets"]])
                   for t in images]
        return len(images), max(b[0] for b in buckets), max(b[1] for b in buckets)

    def free(self) -> None:
        self.check = {k: ([t.cpu() for t in v] if isinstance(v, list)
                          else {n: t.cpu() for n, t in v.items()})
                      for k, v in self.check.items()}
        del self.model, self.opt, self.batches

    # ------------------------------------------------------------------ check
    def reference_batch(self, images: List[traffic.TrainImage]):
        """The reference's own batch: normalised pixels padded to the batch's
        bucket, its tokenisation, targets as normalised cxcywh padded to
        `max_boxes`."""
        buckets = [rdata.pick_bucket(t.image.shape[0], t.image.shape[1],
                                     [tuple(b) for b in self.mix["shape_buckets"]])
                   for t in images]
        bucket = (max(b[0] for b in buckets), max(b[1] for b in buckets))
        px, mask = rdata.pad_batch([t.image for t in images], bucket)
        dev = self.device
        px, mask = torch.from_numpy(px).to(dev), torch.from_numpy(mask).to(dev)
        tb = rtext.text_batch(self.vocab, [traffic.caption(t.names) for t in images],
                              self.mix["text_len_buckets"],
                              max_text_len=self.mix["text_len_buckets"][-1],
                              max_categories=self.mix["max_categories"])
        n = self.mix["max_boxes"]
        gl = np.zeros((len(images), n), np.int64)
        gb = np.zeros((len(images), n, 4), np.float32)
        gv = np.zeros((len(images), n), bool)
        for i, t in enumerate(images):
            h, w = t.image.shape[:2]
            k = min(len(t.labels), n)
            b = t.boxes_xyxy[:k] / np.array([w, h, w, h], np.float32)
            gb[i, :k] = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                                  b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)
            gl[i, :k] = t.labels[:k]
            gv[i, :k] = True
        batch = {k: torch.from_numpy(v).to(dev) for k, v in tb.items()}
        batch.update(gt_labels=torch.from_numpy(gl).to(dev), gt_boxes=torch.from_numpy(gb).to(dev),
                     gt_valid=torch.from_numpy(gv).to(dev))
        return px, mask, batch
