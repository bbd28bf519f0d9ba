"""The port's trainer and lifecycle driver on the CPU, at a tiny config:

* a run cut after a mid-task checkpoint and resumed from it ends bitwise
  where an uninterrupted run ends (weights, AdamW, schedule, EMA), with
  dropout on;
* `Optimizer.state_dict` round trip; `fast_dev_run`; `metrics.jsonl`'s
  `step_time` ending on a synchronise of the device at each log;
* a mini ODinW run through the driver's `main()` on two synthetic tasks:
  the checkpoint's prompt memory in the chain, every merge's algebra, the
  report; a second call restores both tasks from `state_final.pt` and
  writes the same report; a run cut inside the second task resumes from
  its checkpoint to the same chained weights, bit for bit.
"""

import dataclasses
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from tests.common import TINY_BERT, tiny_config, tiny_tokenizer
from tests.torch_common import port_config
from ziragroundingdino_torch.config import DataConfig, OptimizerConfig, ScheduleConfig, TrainConfig
from ziragroundingdino_torch.data.loader import DataLoader
from ziragroundingdino_torch.data.coco import CocoDataset
from ziragroundingdino_torch.data.synthetic import write_coco_split, write_odinw_task, write_vocab
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.models.zira import ZERO_VALUE
from ziragroundingdino_torch.train import optim
from ziragroundingdino_torch.train.trainer import (
    Trainer,
    checkpoint_step,
    latest_checkpoint,
    restore_checkpoint,
)
from ziragroundingdino_torch.utils import profiling

DATA = dict(train_short_sides=(64, 96), max_size=160, test_short_side=96,
            shape_buckets=((96, 128), (128, 160), (160, 224)), max_boxes=10, num_workers=0)
MERGE_TOL = 1e-6  # freeze + scaling * branch, one f32 multiply-add


def _dropout_config():
    """The tiny config with dropout and stochastic depth on, so that the
    per-iteration generator matters."""
    return port_config(tiny_config(
        fusion_droppath=0.1, bert_config=dataclasses.replace(
            TINY_BERT, hidden_dropout=0.1, attention_dropout=0.1)))


def _trainer(tmp_path, out, start_batch=0):
    model = build_model(_dropout_config(), device="cpu", seed=0)
    optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
    opt = optim.Optimizer(model, OptimizerConfig(lr=1e-2, lr_factors=(("freeze", 0.2),)),
                          ScheduleConfig(max_iter=4, milestones_frac=(0.4,)), ema_decay=0.9)
    root = tmp_path / "data"
    if not root.exists():
        write_coco_split(str(root), ["cat", "dog"], 4, (96, 128), seed=0)
    ds = CocoDataset.from_json(str(root / "annotations_without_background.json"), str(root))
    loader = DataLoader(ds, tiny_tokenizer(), DataConfig(**DATA), batch_size=2, seed=3,
                        max_text_len=32, max_categories=8, start_batch=start_batch)
    cfg = TrainConfig(output_dir=str(tmp_path / out), max_iter=4, checkpoint_period=2,
                      log_period=1)
    return model, opt, Trainer(model, opt, loader, cfg)


def test_resume_from_a_mid_task_checkpoint_is_bitwise(tmp_path):
    model, opt, tr = _trainer(tmp_path, "whole")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    tr.train(0, 4)

    _, _, cut = _trainer(tmp_path, "cut")
    cut.train(0, 2)  # ends after the checkpoint of iteration 2
    path = latest_checkpoint(str(tmp_path / "cut" / "ckpt"))
    assert checkpoint_step(path) == 2
    model2, opt2, resumed = _trainer(tmp_path, "cut", start_batch=2)
    assert resumed.resume_or_load() == 2
    resumed.train(2, 4)

    for n, p in model.named_parameters():
        assert torch.equal(p, dict(model2.named_parameters())[n]), n
    for n, e in opt.ema.items():
        assert torch.equal(e, opt2.ema[n]), n
    assert opt.schedule.last_epoch == opt2.schedule.last_epoch == 4
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, start[n])]
    assert moved and all("adapter" in n for n in moved)
    lines = (tmp_path / "whole" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["iteration"] for x in lines] == [1, 2, 3, 4]
    ckpt = restore_checkpoint(str(tmp_path / "whole" / "ckpt" / "step_4.pt"))
    assert ckpt["step"] == 4 and ckpt["optimizer"]["ema"].keys() == opt.ema.keys()


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.adapter = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
        self.freeze_adapter = torch.nn.Parameter(torch.ones(3))
        self.base = torch.nn.Parameter(torch.zeros(2), requires_grad=False)


def test_optimizer_state_dict_round_trip():
    """Saved and loaded with `weights_only=True`, the state continues the
    run exactly: moments, step counts, the schedule and the EMA."""
    def make(ema=0.5):
        m = _Tiny()
        return m, optim.Optimizer(m, OptimizerConfig(lr=0.1, lr_factors=(("freeze", 0.2),)),
                                  ScheduleConfig(max_iter=4, milestones_frac=(0.5,)),
                                  ema_decay=ema)

    def step(m, o, k):
        m.adapter.grad = torch.full((2, 3), 0.3 * k)
        m.freeze_adapter.grad = torch.full((3,), -0.2 * k)
        o.step()

    m, o = make()
    for k in range(3):
        step(m, o, k + 1)
    buf = io.BytesIO()
    torch.save({"model": m.state_dict(), "optimizer": o.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    m2, o2 = make()
    m2.load_state_dict(saved["model"])
    o2.load_state_dict(saved["optimizer"])
    for mm, oo in ((m, o), (m2, o2)):
        step(mm, oo, 4)
    for (n, a), b in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
    assert all(torch.equal(o.ema[n], o2.ema[n]) for n in o.ema)
    assert o.adamw.param_groups[0]["lr"] == o2.adamw.param_groups[0]["lr"]
    with pytest.raises(ValueError, match="EMA"):
        make(ema=None)[1].load_state_dict(saved["optimizer"])


def test_fast_dev_run_stops_at_20_iterations(tmp_path):
    m = _Tiny()
    o = optim.Optimizer(m)
    calls = []

    def step_fn(model, optimizer, batch, generator):
        calls.append(batch["x"].item())
        return {"total_loss": torch.tensor(1.0)}

    def batches():
        i = 0
        while True:
            yield {"x": np.asarray(i), "real_count": np.asarray(1)}
            i += 1

    cfg = TrainConfig(output_dir=str(tmp_path), max_iter=50, checkpoint_period=1000,
                      log_period=5, fast_dev_run=True)
    Trainer(m, o, batches(), cfg, step_fn=step_fn).train()
    assert calls == list(range(20))
    assert checkpoint_step(latest_checkpoint(str(tmp_path / "ckpt"))) == 20
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 4


def test_step_time_counts_the_device_at_each_log(tmp_path, monkeypatch):
    """The trainer synchronises the device once at each log boundary,
    inside `step_time`: a period's `step_time + data_time` is its wall time
    from its first batch's fetch to the end of that synchronise, which here
    stands for the device finishing the period's queued work."""
    marks = {"fetch": [], "synced": []}

    def synchronize(device=None):
        time.sleep(0.03)
        marks["synced"].append(time.perf_counter())

    monkeypatch.setattr(profiling, "synchronize", synchronize)

    def step_fn(model, optimizer, batch, generator):
        time.sleep(0.01)
        return {"total_loss": torch.tensor(1.0)}

    def batches():
        while True:
            marks["fetch"].append(time.perf_counter())
            time.sleep(0.005)
            yield {"x": np.asarray(0), "real_count": np.asarray(1)}

    m = _Tiny()
    cfg = TrainConfig(output_dir=str(tmp_path), max_iter=6, checkpoint_period=1000, log_period=3)
    Trainer(m, optim.Optimizer(m), batches(), cfg, step_fn=step_fn).train()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [3, 6] and len(marks["synced"]) == 2
    for k, line in enumerate(lines):
        wall = marks["synced"][k] - marks["fetch"][3 * k]
        assert line["step_time"] >= 3 * 0.01 + 0.03 and line["data_time"] >= 3 * 0.005
        assert line["step_time"] + line["data_time"] == pytest.approx(wall, rel=0.05)


TINY_MODEL = {
    "hidden_dim": 64, "nheads": 4, "dim_feedforward": 128, "enc_layers": 2, "dec_layers": 2,
    "num_queries": 12, "max_text_len": 32, "max_categories": 8, "compute_dtype": "float32",
    "fusion_droppath": 0.0, "use_add_names": True, "use_learned_names": True,
    "swin_config": {"embed_dim": 8, "depths": [1, 1, 1, 1], "num_heads": [1, 2, 4, 8],
                    "window_size": 4, "drop_path_rate": 0.0, "out_indices": [1, 2, 3]},
    "bert_config": {"vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 2,
                    "num_attention_heads": 2, "intermediate_size": 64,
                    "max_position_embeddings": 64, "hidden_dropout": 0.0,
                    "attention_dropout": 0.0},
}
TASKS = {"CottontailRabbits": ["cat", "dog", "zebra"], "pothole": ["person", "car"]}


@pytest.fixture(scope="module")
def odinw(tmp_path_factory):
    """A tiny reference-format checkpoint with a prompt memory entry, a
    vocab, the overrides and two synthetic ODinW tasks."""
    from ziragroundingdino_torch.config import load_config_overrides

    root = tmp_path_factory.mktemp("odinw")
    ov = root / "overrides.json"
    ov.write_text(json.dumps({"model": TINY_MODEL, "data": DATA}))
    model = build_model("dualzerorepbranchgroundingdino", device="cpu", seed=0,
                        **load_config_overrides(str(ov))[0])
    sd = dict(model.state_dict())
    sd["prompt_memory_pool.-fish-"] = torch.randn(2, 64, generator=torch.Generator().manual_seed(0))
    torch.save({"model": sd}, root / "ckpt.pth")
    write_vocab(str(root / "vocab.txt"), tiny_tokenizer().vocab)
    for i, (name, classes) in enumerate(TASKS.items()):
        write_odinw_task(str(root / "data"), name, classes, 4, 3, (96, 128), seed=10 * i)
    return root


def _main(root, out, *extra):
    from ziragroundingdino_torch.scripts import train_odinw

    return train_odinw.main([
        "--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
        "--datasets-root", str(root / "data"), "--tasks", ",".join(TASKS),
        "--output-dir", str(out), "--batch-size", "2", "--max-iter", "2",
        "--checkpoint-period", "1", "--replay-iters", "2",
        "--config-overrides", str(root / "overrides.json"), "--device", "cpu", *extra])


def _state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_mini_odinw_lifecycle_through_the_driver(odinw, tmp_path):
    out = tmp_path / "out"
    report = _main(odinw, out)
    assert set(report) == {"AP/CottontailRabbits", "AP/pothole", "avg_AP"}
    assert all(np.isfinite(v) for v in report.values())
    assert json.loads((out / "result.json").read_text()) == report

    before = _state(odinw / "ckpt.pth")["model"]
    for name, classes in TASKS.items():
        final = _state(out / name / "state_final.pt")
        trained = _state(out / name / "ckpt" / "step_2.pt")["model"]
        params = final["params"]
        for k, v in params.items():
            if "adapter" not in k:
                assert torch.equal(v, before[k]), (name, k)
        for mod in ["rep_linear_adapter"] + [f"input_proj_conv_adapter.{i}" for i in range(4)]:
            freeze = "freeze_linear" if mod == "rep_linear_adapter" else "freeze_conv"
            s = trained[f"{mod}.scaling"]
            for part in ("weight", "bias"):
                want = trained[f"{mod}.{freeze}.{part}"] + s * trained[f"{mod}.{part}"]
                torch.testing.assert_close(params[f"{mod}.{freeze}.{part}"], want,
                                           atol=MERGE_TOL, rtol=0)
                assert torch.all(params[f"{mod}.{part}"] == ZERO_VALUE)
            assert torch.all(params[f"{mod}.scaling"] == 0.1)
        assert set(final["prompt_memory"]) >= {"-fish-"} | {f"-{c}-" for c in classes}
        before = params
    assert json.loads((out / "pothole" / "state_final.pt.classes.json").read_text()) == \
        TASKS["CottontailRabbits"] + TASKS["pothole"]
    torch.testing.assert_close(_state(out / "pothole" / "state_final.pt")["prompt_memory"]["-fish-"],
                               _state(odinw / "ckpt.pth")["model"]["prompt_memory_pool.-fish-"],
                               atol=0, rtol=0)

    # a second call restores both tasks and reports the same
    assert _main(odinw, out) == report

    # a run cut after iteration 1 of the second task resumes there
    b = out / "pothole"
    chained = _state(b / "state_final.pt")["params"]
    for f in ("state_final.pt", "state_final.pt.classes.json"):
        os.remove(b / f)
    (b / "ckpt" / "last_checkpoint").write_text("step_1.pt")
    assert _main(odinw, out) == report
    for k, v in _state(b / "state_final.pt")["params"].items():
        assert torch.equal(v, chained[k]), k

    with pytest.raises(SystemExit, match="stamped"):
        _main(odinw, out, "--lr", "0.5")


def test_eval_coco_driver(odinw, tmp_path):
    """The standalone evaluator on one synthetic split: the 12 COCO metrics,
    the per-category table and the json it writes."""
    from ziragroundingdino_torch.scripts import eval_coco

    split = odinw / "data" / "CottontailRabbits" / "test"
    out = tmp_path / "result.json"
    res = eval_coco.main([
        "--checkpoint", str(odinw / "ckpt.pth"), "--vocab", str(odinw / "vocab.txt"),
        "--json", str(split / "annotations_without_background.json"),
        "--image-root", str(split), "--batch-size", "2", "--max-images", "3",
        "--config-overrides", str(odinw / "overrides.json"), "--device", "cpu",
        "--output", str(out)])
    assert res["n_images"] == 3 and np.isfinite(res["AP"])
    assert set(res["per_category_AP"]) == set(TASKS["CottontailRabbits"])
    assert json.loads(out.read_text())["AP"] == res["AP"]
