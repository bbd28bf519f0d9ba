"""The harness's start of a cell over several ranks (`run.py::start_ranks`)
on the CPU: the data-parallel cell on 2 gloo ranks at the tiny
configuration in float32, its workers forked from the test process."""

import json
import time

import pytest
import torch

import benchmark.run as bench
from benchmark.lib import check, weights
from benchmark.lib.ddp import DDPTrainRun
from benchmark.lib.train import TrainRun
from benchmark.reference.model import RefConfig, state_shapes
from benchmark.tests.ranks import CELL, MANIFEST, ranks_cell, run_ranks
from benchmark.tests.tiny import tiny_mix

SEED = 2**31 + 45


def lines(capsys):
    return [x for x in capsys.readouterr().out.strip().splitlines() if x]


def test_ranks_run_and_rank_0_prints_the_result(monkeypatch, capsys):
    ranks_cell(monkeypatch)
    assert run_ranks(SEED) == 0
    out = lines(capsys)
    assert len(out) == 1
    result = json.loads(out[0])
    assert result["correct"], result["check"]
    assert result["device"]["count"] == 2 and result["attempted"] > 0
    assert result["check"]["rank_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}


def test_gathered_selections_and_assignments_are_one_process(monkeypatch, capsys, tmp_path):
    """Without dropout the ranks' selections and assignments, gathered in
    global batch order, are those of one process stepping on the global
    batch."""
    w, conf, mix = ranks_cell(monkeypatch, dropout=False)
    real = check.run_check

    def kept(run, state):
        torch.save({k: run.check[k] for k in ("topk", "matched")}, tmp_path / "ranks.pt")
        return real(run, state)

    monkeypatch.setattr(check, "run_check", kept)
    assert run_ranks(SEED) == 0
    assert json.loads(lines(capsys)[-1])["correct"]
    ranks = torch.load(tmp_path / "ranks.pt")
    one = TrainRun(conf, dict(mix, kind="train"), SEED, torch.device("cpu"))
    shapes = state_shapes(RefConfig.from_file(conf))
    one.setup(weights.make_state_dict(shapes, SEED, torch.device("cpu")))
    for k in ("topk", "matched"):
        assert len(ranks[k]) == len(one.check[k]) == mix["check"]["steps"]
        for a, b in zip(ranks[k], one.check[k]):
            assert torch.equal(a, b), k


def test_a_failing_rank_ends_the_run(monkeypatch, capsys):
    """Rank 1 raises in set-up while rank 0 waits in a collective: the
    run ends non-zero within its own limit, prints no result, and leaves
    no worker running."""
    import multiprocessing
    import os

    ranks_cell(monkeypatch)
    real = DDPTrainRun.setup

    def failing(self, state):
        if os.environ["RANK"] == "1":
            raise RuntimeError("a planted failure of rank 1")
        return real(self, state)

    monkeypatch.setattr(DDPTrainRun, "setup", failing)
    t = time.monotonic()
    assert run_ranks(SEED) != 0
    assert time.monotonic() - t < 60
    assert lines(capsys) == []
    assert multiprocessing.active_children() == []


def test_hung_ranks_are_ended_at_the_limit(monkeypatch, capsys):
    """Ranks that outlast `--seconds` plus the allowance are ended: no
    result, a non-zero exit, no worker left."""
    import multiprocessing

    ranks_cell(monkeypatch)
    monkeypatch.setattr(bench, "RANK_ALLOWANCE_S", 0.0)
    monkeypatch.setattr(DDPTrainRun, "setup", lambda self, state: time.sleep(600))
    t = time.monotonic()
    assert run_ranks(SEED) != 0
    assert time.monotonic() - t < 30
    assert lines(capsys) == []
    assert multiprocessing.active_children() == []


def test_unknown_kind_exits_with_the_known_kinds(monkeypatch, capsys):
    monkeypatch.setattr(bench, "load_cell",
                        lambda name: (MANIFEST, CELL, {}, {"kind": "train-pipe"}, {}))
    assert bench.main(["--workload", CELL["name"], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "train-ddp" in out.err and "serve" in out.err


def test_fewer_cards_than_the_cell_exits_2(monkeypatch, capsys):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("a machine with the cell's four cards runs it")
    mix = tiny_mix(CELL["traffic"])
    monkeypatch.setattr(bench, "load_cell", lambda name: (MANIFEST, CELL, {}, mix, {}))
    assert bench.main(["--workload", CELL["name"], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 4 CUDA card(s)" in out.err
