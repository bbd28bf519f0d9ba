"""Data-parallel training cells: `TrainRun`'s cycle, check and window on a
data mesh of the traffic's `ranks` processes, one a card, under the port's
DDP (`parallel.mesh.make_mesh(data=ranks)`, `train.step.wrap_ddp` over the
same `train_step`). `benchmark/run.py` starts the processes.

Each global batch of the cycle is the batch that the one-card cell makes
from the same seed (the port's `collate` of all its images, padded to its
bucket); rank r takes its rows r * b .. (r + 1) * b - 1, b = batch / ranks,
so every rank's tensors have one shape, as the port's sharded loader pins
them. Each rank draws its dropout from the generator the port's `Trainer`
gives data rank r at that iteration (`rank_generator`).

Set-up: every rank makes the seed's weights; one all-reduced checksum of
the state dict holds every rank to the same state; then `TrainRun.setup`
runs on this class's batches and step: the check's three steps (each rank
records its selections and assignments) and the cycle's other shapes.
Rank 0 then holds the selections and assignments of all ranks in global
batch order, its own averaged first gradient and change, and `rank_gap`:
how far any rank's first gradient or change lies from rank 0's (0 when
DDP hands every rank the same average).

The window opens after a barrier and a synchronise on every rank and
closes on the same. Every rank runs the same steps: rank 0 times the
window's first `PROBE_STEPS` and tells the others, once, how many steps
fill `--seconds` at that pace; nothing else holds the ranks together but
DDP's own collectives, so a rank that falls behind shows as the others'
wait in them. `train_img_per_s` is the global images of the window's
steps over rank 0's window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.lib.train import TrainRun, iteration_generator

PROBE_STEPS = 4  # steps of the window that rank 0 times before the ranks agree on its length


def rank_generator(seed: int, it: int, rank: int, device) -> torch.Generator:
    """The generator of iteration `it` on data rank `rank`, seeded from
    (seed, it) on rank 0 and (seed, it, rank) on the others, as the port's
    `Trainer` seeds it."""
    if rank == 0:
        return iteration_generator(seed, it, device)
    state = np.random.SeedSequence([seed, it, rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


def state_checksum(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each tensor's sum and sum of magnitudes, in float64, in key order."""
    return torch.stack([torch.stack([v.double().sum(), v.double().abs().sum()])
                        for _, v in sorted(state.items())]).flatten()


@dataclass
class DDPTrainRun(TrainRun):
    rank: int = 0
    world: int = 1
    ddp: Optional[torch.nn.Module] = None

    @property
    def shard(self) -> int:
        return self.mix["batch"] // self.world

    def setup(self, state: Dict[str, torch.Tensor]) -> None:
        import torch.distributed as tdist

        from ziragroundingdino_torch.parallel import dist, mesh

        self.world = self.mix["ranks"]
        if dist.process_count() != self.world:
            raise RuntimeError(f"the traffic asks for {self.world} ranks; the process group "
                               f"holds {dist.process_count()}")
        self.rank = dist.process_index()
        self.mesh = mesh.make_mesh(data=self.world)
        self.host = tdist.new_group(backend="gloo")
        c = state_checksum(state)
        hi, lo = c.clone(), c.clone()
        tdist.all_reduce(hi, op=tdist.ReduceOp.MAX)
        tdist.all_reduce(lo, op=tdist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            raise RuntimeError("the ranks were handed different weights")
        super().setup(state)
        self.check["topk"] = [self.gathered(t, 0) for t in self.check["topk"]]
        self.check["matched"] = [self.gathered_matches(t) for t in self.check["matched"]]
        self.rank_numbers = {"rank_gap": max(self.rank_gap(self.check["grads"]),
                                             self.rank_gap(self.check["change"]))}

    def gathered(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `t`, concatenated along `dim` in rank order."""
        import torch.distributed as tdist

        parts = [torch.empty_like(t) for _ in range(self.world)]
        tdist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim)

    def gathered_matches(self, t: torch.Tensor) -> torch.Tensor:
        """A step's assignments [outputs x shard, N] of every rank as the
        global batch's [outputs x batch, N]: output-major, images in global
        order."""
        n = t.shape[-1]
        per = t.reshape(-1, self.shard, n)
        return self.gathered(per, 1).reshape(-1, n)

    def rank_gap(self, tensors: Dict[str, torch.Tensor]) -> float:
        """The largest difference of any rank's tensors from rank 0's, over
        the largest magnitude of rank 0's."""
        import torch.distributed as tdist

        flat = torch.cat([tensors[k].detach().float().flatten() for k in sorted(tensors)])
        ref = flat.clone()
        tdist.broadcast(ref, src=0)
        diff = (flat - ref).abs().max().reshape(1)
        tdist.all_reduce(diff, op=tdist.ReduceOp.MAX)
        return float(diff / ref.abs().max().clamp(min=1e-30))

    def port_batch(self, images) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch as the one-card cell collates it."""
        batch = super().port_batch(images)
        lo = self.rank * self.shard
        return {k: v[lo:lo + self.shard].clone() for k, v in batch.items()}

    def step(self):
        from ziragroundingdino_torch.train.step import train_step, wrap_ddp

        if self.ddp is None:
            self.ddp = wrap_ddp(self.model, self.conf["train"]["matcher"])
        batch = self.batches[self.it % len(self.batches)]
        gen = rank_generator(self.seed, self.it, self.rank, self.device)
        out = train_step(self.ddp, self.opt, batch, generator=gen)
        self.it += 1
        self.steps += 1
        self.images += batch["pixels"].shape[0] * self.world
        return out

    def agreed_steps(self, seconds: float, probe_s: float) -> int:
        """The window's steps on every rank: as many as rank 0's first
        `PROBE_STEPS`, `probe_s` seconds, make fit into `seconds`; one
        host-side (gloo) broadcast."""
        import torch.distributed as tdist

        n = torch.tensor([max(PROBE_STEPS, round(seconds * PROBE_STEPS / probe_s))])
        tdist.broadcast(n, src=0, group=self.host)
        return int(n)

    def _sync(self) -> None:
        from ziragroundingdino_torch.parallel import dist

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dist.barrier()

    def window(self, seconds: float, tracer=None) -> None:
        self.steps = self.images = 0
        self._sync()
        t0 = time.perf_counter()
        self.window_losses = []
        total = None
        while total is None or self.steps < total:
            if total is None and self.steps == PROBE_STEPS:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                total = self.agreed_steps(seconds, time.perf_counter() - t0)
                continue
            if tracer is not None:
                tracer.begin(self.it, self.it % len(self.batches))
            self.window_losses.append(self.step()["total_loss"])
            if tracer is not None:
                tracer.end(self.it - 1)
        self._sync()
        self.window_s = time.perf_counter() - t0

    def flops_keys(self, index: int):
        """(h, w, T) of this rank's images of a cycle batch."""
        lo = self.rank * self.shard
        return super().flops_keys(index)[lo:lo + self.shard]

    def device_shape(self, index: int):
        """(this rank's batch, H, W) of a cycle batch as its step runs it."""
        _, h, w = super().device_shape(index)
        return self.shard, h, w

    def free(self) -> None:
        self.ddp = None
        super().free()
