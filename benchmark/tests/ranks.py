"""The data-parallel cell over 2 gloo ranks on the CPU, through
`run.py::start_ranks`, whose workers fork from the test process there, so
that what a test plants in the harness or the program reaches every rank."""

import copy
import json

import benchmark.run as bench
from benchmark.tests.tiny import tiny_config, tiny_mix

MANIFEST = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
# the cell as `BENCHMARK.json` would hold it: `zira-t.train-b8`'s global batch
# on a data mesh of 4 cards (2 gloo ranks at the tiny size)
CELL = {"name": "zira-t.train-ddp4", "config": "zira-t", "traffic": "train-ddp4", "chips": 4,
        "why": "train-b8's global batch on 4 cards, 2 images a card, DDP over NCCL"}
# float32 on both sides, as `test_bench_faults.TRAIN`; every rank holds rank 0's average
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-4, "update_worst": 1e-4,
          "unmoved": 0.0, "select_gap": 1e-4, "match_gap": 1e-6, "rank_gap": 0.0}


def with_cell(manifest, cell):
    """`manifest` with `cell` added, reporting every metric that
    `zira-t.train-b8` reports."""
    m = copy.deepcopy(manifest)
    m["workloads"].append(cell)
    for metric in m["end_to_end"] + m["per_layer"]:
        if "zira-t.train-b8" in metric.get("workloads", []):
            metric["workloads"].append(cell["name"])
    return m


def ranks_cell(monkeypatch, dropout: bool = True):
    """The data-parallel cell at the tiny size on 2 gloo ranks: (cell,
    configuration, traffic), `load_cell` patched to give them."""
    w = dict(CELL, chips=2)
    conf = tiny_config(w["config"])
    conf["model"]["compute_dtype"] = "float32"
    if not dropout:
        conf["model"]["fusion_droppath"] = 0.0
        conf["swin"]["drop_path_rate"] = 0.0
        conf["bert"] = {k: (0.0 if "dropout" in k else v) for k, v in conf["bert"].items()}
    mix = tiny_mix(w["traffic"])
    manifest = with_cell(MANIFEST, w)
    monkeypatch.setattr(bench, "load_cell", lambda name: (manifest, w, conf, mix, LIMITS))
    return w, conf, mix


def run_ranks(seed: int, seconds: str = "1") -> int:
    """`run.py` over the ranks; its exit code."""
    argv = ["--workload", CELL["name"], "--seed", str(seed), "--seconds", seconds,
            "--trace", "0"]
    return bench.main(argv, device_override="cpu")
