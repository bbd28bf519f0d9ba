#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. The
cell (`BENCHMARK.json`'s `workloads`) names a configuration, found in
`benchmark/configs/<config>.json`, and a traffic mix, found in
`benchmark/traffic/<traffic>.json`; its per-layer metrics are read by
`benchmark/metrics/<metric>.py` and its check's limits are in
`benchmark/limits/<cell>.json`. The traffic's `kind` picks the run class
from `RUNS`: a new cell of a kind in the table, or a new metric, needs only
new files and entries; a new kind adds one module under `benchmark/lib/`
and one line of the table.

A cell of more than one card runs as that many worker processes, one a
card, which this process spawns (`start_ranks`, over
`torch.multiprocessing`) once it has built the port's CUDA kernels, in the
environment that `torchrun` gives (`parallel/dist.py::init_from_env`,
NCCL). Each worker runs this file's `run_cell` on an equal share of the
host's CPUs (`cpu_shares`), with as many threads; rank 0 alone prints the
result, which this process passes on only when every worker has ended
with 0. A worker that fails, or the workers outlasting `--seconds` plus
`RANK_ALLOWANCE_S`, takes all of them down, with a non-zero exit.
`setup_s` is then counted from this process's start to the first timed
step, after a barrier on all ranks; `memory_peak_bytes` is the fullest
card's, and a traced run traces rank 0.

A run: set-up (imports, the port's kernels, the seed's weights made on the
card, the traffic, the cell's warm-ups), then `--seconds` of measured
window, then the check against the plain reference once the program's
state is freed. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the end-to-end metrics with
`--trace 0`, the per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `check`: each compared number with its
limit, which the last lines of standard error repeat.

No CUDA card, fewer cards than the cell asks for, a traffic kind outside
`RUNS`, or JAX (or the JAX package) loaded in any rank once the window has
closed: a message on standard error, no result, a non-zero exit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import signal
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ziragroundingdino_tpu")
# traffic kind -> (module under benchmark/lib, run class, trace schedule and counts)
RUNS = {
    "serve": ("serve", "ServeRun", "serve"),
    "train": ("train", "TrainRun", "train"),
    "train-ddp": ("ddp", "DDPTrainRun", "train"),
}
# a worker's environment: the start of the process that started it (epoch
# seconds) and that process's id
PARENT_T0, PARENT_PID = "HARNESS_PARENT_T0", "HARNESS_PARENT_PID"
RANK_ALLOWANCE_S = 300.0  # a multi-card run's set-up and check, past --seconds


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was loaded."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / ticks
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def load_cell(workload: str):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    conf = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_file = BENCH / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}
    return manifest, cell, conf, mix, limits


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class LayerContext:
    """What a per-layer metric's reader reads: the trace's aggregates, the
    run (its configuration, traffic and profiled steps) and the counts.
    `kind` is the run's family, "serve" or "train"."""

    def __init__(self, kind, trace, run, conf, extra):
        self.kind, self.trace, self.run, self.conf = kind, trace, run, conf
        self.extra = extra
        self._flops = None

    def model_flops(self) -> float:
        """Model FLOPs of the profiled steps' work."""
        from benchmark.lib import counts

        if self._flops is None:
            mf = counts.ModelFlops(self.conf, train=self.kind == "train",
                                   trainable=self.conf.get("train", {}).get("trainable",
                                                                            ("adapter",)))
            self._flops = float(sum(mf(h, w, t) for item in self.trace.items
                                    for h, w, t in self.run.flops_keys(item)))
        return self._flops

    def msda_calls(self):
        """(b, q, s) of every MSDA call of the profiled steps' forward passes
        (as many backward calls in training), at the shapes the kernels ran
        at: the encoder's layers over every token, the decoder's over the
        queries."""
        from benchmark.lib.counts import conf_level_shapes

        m = self.conf["model"]
        out = []
        for item in self.trace.items:
            b, h, w = self.run.device_shape(item)
            s = sum(hh * ww for hh, ww in conf_level_shapes(self.conf, h, w))
            out += [(b, s, s)] * m["enc_layers"] + [(b, m["num_queries"], s)] * m["dec_layers"]
        return out

    def msda_bounds(self, bound):
        """`bound` (`counts.msda_forward_bound` or `msda_backward_bound`) of
        every call of `msda_calls`, at the configuration's heads, head size,
        levels and each layer's points."""
        m = self.conf["model"]
        heads, d = m["nheads"], m["hidden_dim"] // m["nheads"]
        per_item = [m["enc_n_points"]] * m["enc_layers"] + [m["dec_n_points"]] * m["dec_layers"]
        points = per_item * len(self.trace.items)
        return [bound(b, q, s, heads, d, m["num_feature_levels"], p)
                for (b, q, s), p in zip(self.msda_calls(), points)]


def run_class(kind: str):
    module, name, _ = RUNS[kind]
    return getattr(importlib.import_module(f"benchmark.lib.{module}"), name)


def main(argv=None, device_override=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    manifest, cell, conf, mix, limits = load_cell(args.workload)
    if mix["kind"] not in RUNS:
        print(f"run.py: traffic kind {mix['kind']!r} is none of the known kinds {sorted(RUNS)}",
              file=sys.stderr)
        return 2
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    print(f"setup: torch imported at {process_age_s():.2f} s", file=sys.stderr)
    if device_override is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"run.py: the cell needs {cell['chips']} CUDA card(s); this machine has "
                  f"{have}", file=sys.stderr)
            return 2
    if cell["chips"] > 1:
        return start_ranks(run_cell, (args, manifest, cell, conf, mix, limits, device_override),
                           cell["chips"], args.seconds + RANK_ALLOWANCE_S, device_override)
    return run_cell(args, manifest, cell, conf, mix, limits, device_override)


# ---------------------------------------------------------------- ranks
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cpu_shares(ranks: int):
    """The CPUs this process may use, in `ranks` equal shares by number."""
    cpus = sorted(os.sched_getaffinity(0))
    n = len(cpus) // ranks
    return [cpus[r * n:(r + 1) * n] or cpus for r in range(ranks)]


def _rank(rank, env, cpus, out, entry, *args):
    """Worker `rank` of `start_ranks`: ended with the process that started
    it, torchrun's environment, its share of the CPUs and so many threads
    (`cpus` None: one thread, as a forked worker needs, since the OpenMP
    threads of the process it forked from are not in it); rank 0's standard
    output into `out`."""
    import contextlib
    import ctypes
    import io

    import torch

    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != int(env[PARENT_PID]):
        os._exit(1)
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    if cpus is None:
        torch.set_num_threads(1)
    else:
        os.sched_setaffinity(0, cpus[rank])
        torch.set_num_threads(len(cpus[rank]))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed if rank == 0 else sys.stderr):
        code = entry(*args)
    if rank == 0:
        out.put(printed.getvalue())
    if code:
        sys.exit(code)


def start_ranks(entry, args, ranks: int, seconds: float, device_override=None) -> int:
    """Run `entry(*args)` in `ranks` workers, rank r on card r, and wait:
    rank 0's standard output is printed once every worker has ended with 0;
    the first to fail, or the workers outlasting `seconds`, ends them all.
    On cards the workers are spawned once the port's kernels are built; on
    the CPU (`device_override`) they fork, so that what a test plants in
    this process reaches them."""
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException

    t0 = time.time() - process_age_s()
    if device_override is None:
        from ziragroundingdino_torch.ops import cuda_build

        built = cuda_build.build_all()
        print(f"setup: kernels built ({', '.join(sorted(built)) or 'none new'}) at "
              f"{process_age_s():.2f} s", file=sys.stderr)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(ranks), PARENT_T0: repr(t0), PARENT_PID: str(os.getpid())}
    method = "spawn" if device_override is None else "fork"
    out = tmp.get_context(method).SimpleQueue()
    cpus = cpu_shares(ranks) if method == "spawn" else None
    ctx = tmp.start_processes(_rank, (env, cpus, out, entry, *args), nprocs=ranks, join=False,
                              start_method=method)
    printed = []
    deadline = time.monotonic() + seconds
    try:
        while not ctx.join(timeout=0.5):
            while not out.empty():
                printed.append(out.get())
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks outlasted {seconds:.0f} s")
    except (ProcessException, TimeoutError) as e:
        print(f"run.py: {e}\nevery rank is ended, no result", file=sys.stderr)
        return 1
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    while not out.empty():
        printed.append(out.get())
    sys.stdout.write("".join(printed))
    sys.stdout.flush()
    return 0


def run_cell(args, manifest, cell, conf, mix, limits, device_override=None) -> int:
    """One run of a cell in this process: the whole run on one card, or this
    rank's part of it in a worker of `start_ranks`."""
    import torch

    ranks = cell["chips"]
    pdist = None
    if ranks > 1:
        from ziragroundingdino_torch.parallel import dist as pdist

        device = pdist.init_from_env(device_override)
    elif device_override is None:
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device_override)
    rank = pdist.process_index() if pdist is not None else 0

    from benchmark.lib import check, weights
    from benchmark.reference.model import RefConfig, state_shapes

    kind = mix["kind"]
    family = RUNS[kind][2]
    shapes = state_shapes(RefConfig.from_file(conf))

    def state():
        return weights.make_state_dict(shapes, args.seed, device)

    run = run_class(kind)(conf, mix, args.seed, device)
    print(f"setup: imports done at {process_age_s():.2f} s", file=sys.stderr)
    run.setup(state())
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if pdist is not None:
        pdist.barrier()
        setup_s = time.time() - float(os.environ[PARENT_T0])
    else:
        setup_s = process_age_s()
    print(f"setup: {setup_s:.2f} s ({', '.join(f'{k} {v:.2f}' for k, v in run.phases.items())})",
          file=sys.stderr)

    tracer, extra = None, {}
    if args.trace and rank == 0:
        from benchmark.lib.instruments import instrument
        from benchmark.lib.trace import Tracer

        tracer = Tracer(family, device)
        extra = instrument(run, device)
        tracer.start()
    run.window(args.seconds, tracer)
    if tracer is not None:
        tracer.stop()
    found = forbidden_modules()
    if found:
        print(f"run.py: these modules are loaded once the window has closed: {found}",
              file=sys.stderr)
        return 3
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if pdist is not None:  # the fullest card's peak
        import torch.distributed as tdist

        peak_t = torch.tensor([peak], dtype=torch.int64, device=device)
        tdist.all_reduce(peak_t, op=tdist.ReduceOp.MAX)
        peak = int(peak_t)
        if rank != 0:
            run.free()
            pdist.destroy()
            return 0
    e2e = run.metrics()
    attempted, failed = run.attempted(), run.failed()
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if extra:
        extra = {k: v() for k, v in extra.items()}  # read the instruments' events
    run.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {},
              "device": dev}
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    if args.trace:
        ctx = LayerContext(family, tracer.result, run, conf, extra)
        for m in manifest["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            value = reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        launches = tracer.result.forward_device_s("msda_forward_kernel")[1]
        print(f"trace: {tracer.result.slices} slices, {len(tracer.result.items)} steps, "
              f"{launches} msda_forward launches in the forward passes for "
              f"{len(ctx.msda_calls())} calls", file=sys.stderr)
        dev["busy_s"] = tracer.result.busy_s
        dev["window_s"] = tracer.result.window_s
        result["breakdown"] = tracer.result.breakdown()
    else:
        e2e["setup_s"] = setup_s
        for m in manifest["end_to_end"]:
            if args.workload in m.get("workloads", [args.workload]) and m["name"] in e2e:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": units[m["name"]]}

    numbers = check.run_check(run, state)
    if pdist is not None:
        pdist.destroy()
    # the limits file names the numbers compared; the others are printed
    compared = list(limits) or list(numbers)
    result["correct"] = bool(failed == 0 and limits and all(
        k in numbers and numbers[k] <= limits[k] for k in limits))
    result["check"] = {k: {"value": numbers.get(k), "limit": limits.get(k)} for k in compared}
    sys.stdout.flush()
    for k, v in numbers.items():
        if k not in compared:
            print(f"not compared {k} {v!r}", file=sys.stderr)
    for k in compared:
        print(f"check {k} {numbers.get(k)!r} limit {limits.get(k)!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
