#!/usr/bin/env python3
"""Read the two ends a cell's limits are set between, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program | --fault half-batch]

By default the control: the plain reference computed in fp8 where the
configuration states bf16, put in the program's place on the cell's own
inputs, compared as a run compares the program. With `--fault half-batch`
a training cell's planted fault instead (the reference in the program's
place, each step's loss over half the batch). With `--program` the
program itself, as a run drives it but without the timed window, for many
seeds in one process (set-up once): serving sends the sample's requests
through the warmed Predictor, training drives set-up's checked steps.

A cell of several cards reads `--program` on its data mesh: one worker a
card (`run.py::start_ranks`), each setting up every seed in turn, rank 0
printing. `--fault own-shard` is a data-parallel cell's fault: rank 0's
rows alone, as a rank that steps without the exchange.

Prints one JSON line per seed, {"seed", "numbers"}, then {"min": {...}}
and {"max": {...}} over the seeds. The benchmark's own runs do not run it.
Serving takes the seed's longest request and the first others of its
cycle as the sample, training the first three batches.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROGRAM_S_PER_SEED = 120.0  # a data-parallel program reading's set-up and check, at most


def sample(cycle, n):
    """The seed's longest request and the first n - 1 others."""
    longest = max(r.longest for r in cycle)
    first = next(r for r in cycle if r.longest == longest)
    return [first] + [r for r in cycle if r is not first][:n - 1]


def program_numbers(conf, mix, seed, device, state):
    """The program's numbers on the seed's sample, as a run would read them
    (on a data mesh: rank 0's; None on the other ranks)."""
    import torch

    from benchmark.lib import check
    from benchmark.lib.ddp import DDPTrainRun
    from benchmark.lib.serve import Sample, ServeRun
    from benchmark.lib.train import TrainRun

    if mix["kind"] == "serve":
        run = ServeRun(conf, mix, seed, device)
        run.setup(state())
        run.samples = [Sample(i, r, None, None) for i, r in
                       enumerate(sample(run.cycle, mix["check"]["requests"]))]
        for j, s in enumerate(run.samples):
            s.results = run.call(s.request)
            run.recorder.keep(j)
            s.recorded = j
        run.keys_after = run.captured()
    else:
        run = (DDPTrainRun if mix["kind"] == "train-ddp" else TrainRun)(conf, mix, seed, device)
        run.setup(state())
    run.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if getattr(run, "rank", 0) != 0:
        return None
    return check.run_check(run, state)


def control_run(cell, conf, mix, seed, device):
    """A run object with the inputs of `seed` and no program state."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.lib import traffic
    from benchmark.lib.serve import Sample, ServeRun, _bucket
    from benchmark.lib.train import TrainRun
    from benchmark.reference import text as rtext

    if mix["kind"] == "serve":
        from ziragroundingdino_torch.config import DataConfig

        run = ServeRun(conf, mix, seed, device)
        run.vocab = rtext.make_vocab(traffic.vocab_words(mix))
        run.dcfg = DataConfig(**{k: (tuple(tuple(b) for b in v) if k == "shape_buckets" else v)
                                 for k, v in mix.get("data", {}).items()})
        run.bsz = _bucket(mix["batch"], mix["predictor"]["batch_buckets"])
        picks = sample(traffic.serve_cycle(mix, seed, device), mix["check"]["requests"])
        run.samples = [Sample(i, r, {}, []) for i, r in enumerate(picks)]
        return run
    run = TrainRun(conf, mix, seed, device)
    run.vocab = rtext.make_vocab(traffic.vocab_words(mix))
    run.cycle = traffic.train_cycle(mix, seed, device)
    return run


def main(argv=None, load=None, device_override=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half-batch", "own-shard"), default=None,
                    help="read a planted fault instead of the control (training cells)")
    ap.add_argument("--program", action="store_true",
                    help="read the program instead of the control")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import run as bench

    bench.cache_dirs()
    _, cell, conf, mix, _ = (load or bench.load_cell)(args.workload)
    ranks = cell["chips"] if args.program else 1
    if ranks > 1:
        return bench.start_ranks(read, (args, cell, conf, mix, ranks, device_override), ranks,
                                 PROGRAM_S_PER_SEED * len(args.seeds), device_override)
    return read(args, cell, conf, mix, ranks, device_override)


def read(args, cell, conf, mix, ranks: int, device_override=None) -> int:
    """Print each seed's numbers, then their least and largest; on a data
    mesh of `ranks`, this rank's part of it (rank 0 prints)."""
    import torch

    from benchmark.lib import check, weights
    from benchmark.reference.model import RefConfig, state_shapes

    pdist = None
    if ranks > 1:
        from ziragroundingdino_torch.parallel import dist as pdist

        device = pdist.init_from_env(device_override)
    else:
        device = torch.device(device_override or "cuda")
    shapes = state_shapes(RefConfig.from_file(conf))
    low, high = {}, {}
    for seed in args.seeds:
        def state(s=seed):
            return weights.make_state_dict(shapes, s, device)

        if args.program:
            numbers = program_numbers(conf, mix, seed, device, state)
            if pdist is not None:
                pdist.barrier()
            if numbers is None:
                continue
        else:
            numbers = check.control_numbers(control_run(cell, conf, mix, seed, device), state,
                                            args.fault)
        print(json.dumps({"seed": seed, "numbers": numbers}), flush=True)
        for k, v in numbers.items():
            low[k] = min(low.get(k, float("inf")), v)
            high[k] = max(high.get(k, float("-inf")), v)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if pdist is not None:
        rank = pdist.process_index()
        pdist.destroy()
        if rank != 0:
            return 0
    print(json.dumps({"min": low}), flush=True)
    print(json.dumps({"max": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
