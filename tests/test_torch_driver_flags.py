"""The port's `train_odinw` with the flags no other port test passes, on the
CPU at `tests/test_cli_mainlines.py`'s tiny overrides (one encoder and one
decoder layer, 8 queries) over synthetic ODinW tasks:

* `--shot 1shot` on the json the port's `write_fewshot_json` wrote, with
  the COCO retention eval (`--coco-json/--coco-root`): each task trains on
  `fewshot_subset`'s images, and the report has every key;
* `--suite odinw35 --tasks` two tasks odinw13 lacks, then a rerun with
  other args: refused, and with `--force-resume` restored from the chained
  states without a step, reporting the same;
* `--ema-decay 0.9 --eval-ema --shuffle --softfreeze-factor 0.5`: the EMA
  after each step as optax's `ema` update computes it from the trainable
  weights, the EMA weights chained into the merge, the shuffled task order,
  and the frozen weights' learning-rate factor.

The EMA is held to its update rule and not to JAX's driver, whose
`--ema-decay` fails at its first step (the EMA and the parameters are one
buffer, donated twice; `ROADMAP.md`, Queue 3).
"""

import json

import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.test_cli_mainlines import TINY_DATA_OVERRIDES, TINY_MODEL_OVERRIDES
from ziragroundingdino_torch.data import fewshot
from ziragroundingdino_torch.data.odinw import ODINW13, ODINW35, get_odinw_task
from ziragroundingdino_torch.data.synthetic import write_coco_split, write_odinw_task, write_vocab
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.scripts import train_odinw
from ziragroundingdino_torch.train import incremental, trainer

ODINW13_TASKS = {"CottontailRabbits": ["cat", "dog", "zebra"], "pothole": ["person", "car"]}
ODINW35_TASKS = {name: ["cat", "dog"] for name in
                 [n for n in ODINW35 if n not in ODINW13][:2]}
EMA_DECAY = 0.9
EMA_TOL = 1e-6


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A tiny reference-format checkpoint, its vocab and overrides, the
    tasks of both suites (6 train and 3 test PPM images each) and a COCO
    split for the retention eval."""
    root = tmp_path_factory.mktemp("flags")
    model_ov = dict(TINY_MODEL_OVERRIDES, use_add_names=True, use_learned_names=True)
    (root / "overrides.json").write_text(json.dumps({"model": model_ov,
                                                     "data": TINY_DATA_OVERRIDES}))
    from ziragroundingdino_torch.config import load_config_overrides

    model = build_model("dualzerorepbranchgroundingdino", device="cpu", seed=0,
                        **load_config_overrides(str(root / "overrides.json"))[0])
    torch.save({"model": model.state_dict()}, root / "ckpt.pth")
    write_vocab(str(root / "vocab.txt"), tiny_tokenizer().vocab)
    for i, (name, classes) in enumerate({**ODINW13_TASKS, **ODINW35_TASKS}.items()):
        write_odinw_task(str(root / "data"), name, classes, 6, 3, (48, 72), seed=10 * i)
    write_coco_split(str(root / "coco"), ["person", "car", "dog"], 3, (48, 72), seed=99)
    return root


def _args(root, out, tasks, *extra):
    return ["--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
            "--datasets-root", str(root / "data"), "--tasks", ",".join(tasks),
            "--output-dir", str(out), "--batch-size", "2", "--max-iter", "2",
            "--config-overrides", str(root / "overrides.json"), "--device", "cpu", *extra]


class _Spy:
    """Records what the driver's tasks train on and run through: the
    datasets of the train loaders, the train steps, the tasks run."""

    def __init__(self, monkeypatch):
        from ziragroundingdino_torch.data import loader as loader_mod

        self.datasets, self.steps, self.tasks, self.premerge = [], [], [], []

        real_loader, real_step = loader_mod.DataLoader, trainer.train_step
        real_run, real_merge = incremental.run_task, incremental.rep_merge

        def data_loader(ds, *a, train=False, **k):
            if train:
                self.datasets.append(ds)
            return real_loader(ds, *a, train=train, **k)

        def step(model, opt, *a, **k):
            if not self.steps or self.steps[-1][0] is not opt:
                self.steps.append((opt, [self._trainable(model, opt)]))
            out = real_step(model, opt, *a, **k)
            self.steps[-1][1].append(self._trainable(model, opt))
            return out

        def run_task(state, task, *a, **k):
            self.tasks.append(task.name)
            return real_run(state, task, *a, **k)

        def merge(model, *a, **k):
            self.premerge.append({n: t.detach().clone() for n, t in model.state_dict().items()})
            return real_merge(model, *a, **k)

        monkeypatch.setattr(loader_mod, "DataLoader", data_loader)
        monkeypatch.setattr(trainer, "train_step", step)
        monkeypatch.setattr(incremental, "run_task", run_task)
        monkeypatch.setattr(incremental, "rep_merge", merge)

    @staticmethod
    def _trainable(model, opt):
        return {n: p.detach().clone() for n, p in opt.params.items()}


def test_fewshot_json_and_coco_retention(inputs, tmp_path, monkeypatch):
    for name in ODINW13_TASKS:
        task = get_odinw_task(name, str(inputs / "data"))
        path = fewshot.write_fewshot_json(task.load_train(), task.train_root, shots=1)
        assert path == get_odinw_task(name, str(inputs / "data"), shot="1shot").train_json
    spy = _Spy(monkeypatch)
    report = train_odinw.main(_args(
        inputs, tmp_path / "out", ODINW13_TASKS, "--shot", "1shot",
        "--coco-json", str(inputs / "coco" / "annotations_without_background.json"),
        "--coco-root", str(inputs / "coco")))
    assert set(report) == {f"AP/{n}" for n in ODINW13_TASKS} | {"avg_AP", "coco_zero_shot_AP"}
    assert all(np.isfinite(v) for v in report.values())
    assert spy.tasks == list(ODINW13_TASKS)
    for ds, name in zip(spy.datasets, ODINW13_TASKS):
        want = fewshot.fewshot_subset(get_odinw_task(name, str(inputs / "data")).load_train(), 1)
        assert [im["id"] for im in ds.images] == [im["id"] for im in want.images]
        assert 0 < len(ds) < 6
    assert json.loads((tmp_path / "out" / "result.json").read_text()) == report


def test_odinw35_tasks_and_force_resume(inputs, tmp_path, monkeypatch):
    out = tmp_path / "out"
    first = train_odinw.main(_args(inputs, out, ODINW35_TASKS, "--suite", "odinw35"))
    assert set(first) == {f"AP/{n}" for n in ODINW35_TASKS} | {"avg_AP"}
    with pytest.raises(SystemExit, match="force-resume"):
        train_odinw.main(_args(inputs, out, ODINW35_TASKS, "--suite", "odinw35", "--lr", "2e-3"))
    spy = _Spy(monkeypatch)
    again = train_odinw.main(_args(inputs, out, ODINW35_TASKS, "--suite", "odinw35",
                                   "--lr", "2e-3", "--force-resume"))
    assert spy.tasks == [] and spy.steps == []  # both tasks restored from state_final.pt
    assert again == first
    with pytest.raises(SystemExit, match="not in suite"):
        train_odinw.main(_args(inputs, tmp_path / "other", ODINW35_TASKS))


def test_ema_eval_ema_shuffle_softfreeze(inputs, tmp_path, monkeypatch):
    from ziragroundingdino_torch.train import optim

    factors = []
    real_init = optim.Optimizer.__init__

    def init(self, model, cfg, *a, **k):
        factors.append(cfg.lr_factors)
        real_init(self, model, cfg, *a, **k)
    monkeypatch.setattr(optim.Optimizer, "__init__", init)
    spy = _Spy(monkeypatch)
    report = train_odinw.main(_args(
        inputs, tmp_path / "out", ODINW13_TASKS, "--ema-decay", str(EMA_DECAY), "--eval-ema",
        "--shuffle", "--softfreeze-factor", "0.5", "--seed", "5"))
    assert set(report) == {f"AP/{n}" for n in ODINW13_TASKS} | {"avg_AP"}

    order = [n for n in ODINW13 if n in ODINW13_TASKS]
    np.random.RandomState(5).shuffle(order)
    assert spy.tasks == order
    assert factors == [(("freeze", 0.5),)] * len(ODINW13_TASKS)
    assert len(spy.steps) == len(ODINW13_TASKS)
    for (opt, weights), premerge in zip(spy.steps, spy.premerge):
        assert len(weights) == 3  # at the optimizer's creation, then after each of 2 steps
        for n, w in weights[0].items():
            ema = w.clone()
            for later in weights[1:]:  # optax.ema without debiasing
                ema = EMA_DECAY * ema + (1 - EMA_DECAY) * later[n]
            torch.testing.assert_close(opt.ema[n], ema, rtol=0, atol=EMA_TOL)
            # --eval-ema: the EMA weights go into the merge, not the raw ones
            torch.testing.assert_close(premerge[n], opt.ema[n], rtol=0, atol=0)
        assert any(not torch.equal(weights[-1][n], opt.ema[n]) for n in opt.ema)
