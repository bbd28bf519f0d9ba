"""The harness driven end to end on the CPU (its look for a card skipped),
at the tiny configuration in float32, with the timed path sound and then
broken underneath: `correct` comes out true, then false for each fault the
cell can have. The data-parallel cell runs on 2 gloo ranks
(`benchmark/tests/ranks.py`), where the exchange between the ranks can be
left out."""

import json

import pytest
import torch

import benchmark.run as bench
from benchmark.tests.tiny import tiny_config, tiny_mix

MANIFEST = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
# float32 on both sides: sound runs read ~1e-7, exact where nothing is rounded
SERVE = {"select_gap": 1e-4, "select_miss": 0.0, "head_gap": 1e-4, "logit_gap": 1e-4,
         "box_gap": 1e-5,
         "post_gap": 0.0, "window_captures": 0.0}
TRAIN = {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-4, "update_worst": 1e-4,
         "unmoved": 0.0, "select_gap": 1e-4, "match_gap": 1e-6}


def run_cell(cell, monkeypatch, capsys, seconds="1"):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    conf = tiny_config(w["config"])
    conf["model"]["compute_dtype"] = "float32"
    mix = tiny_mix(w["traffic"])
    limits = SERVE if mix["kind"] == "serve" else TRAIN
    monkeypatch.setattr(bench, "load_cell", lambda name: (MANIFEST, w, conf, mix, limits))
    assert bench.main(["--workload", cell, "--seed", str(2**31 + 21), "--seconds", seconds,
                       "--trace", "0"], device_override="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["zira-t.serve-odinw", "zira-t.serve-coco", "zira-t.train-b8"])
def test_sound_run_is_correct(cell, monkeypatch, capsys):
    out = run_cell(cell, monkeypatch, capsys)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("cell", ["zira-t.serve-odinw", "zira-t.serve-coco"])
def test_altered_answer(cell, monkeypatch, capsys):
    """A detection's score altered where the Predictor's graph produces it."""
    import ziragroundingdino_torch.utils.predictor as predictor

    real = predictor.top_k_detections

    def altered(*args, **kwargs):
        det = real(*args, **kwargs)
        det["scores"] = det["scores"].clone()
        det["scores"][:, 3] += 1e-3
        return det

    monkeypatch.setattr(predictor, "top_k_detections", altered)
    out = run_cell(cell, monkeypatch, capsys)
    assert not out["correct"] and out["check"]["post_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["zira-t.serve-odinw", "zira-t.serve-coco"])
def test_wrong_queries_selected(cell, monkeypatch, capsys):
    """The two-stage head's selection altered where it is produced: the
    lowest-scoring queries instead of the best. The reference's decoder
    follows the program's selection, so only the selection's own number
    can see it."""
    import ziragroundingdino_torch.models.transformer as transformer

    real = transformer.select_topk

    def worst(scores, k):
        return real(-scores, k)

    monkeypatch.setattr(transformer, "select_topk", worst)
    out = run_cell(cell, monkeypatch, capsys)
    assert not out["correct"] and out["check"]["head_gap"]["value"] > SERVE["head_gap"]


def test_half_the_batch_served(monkeypatch, capsys):
    """serve-coco's batch of 2: the model computes the first image and
    answers it for both."""
    from ziragroundingdino_torch.models.groundingdino import GroundingDINO

    real = GroundingDINO.forward

    def half(self, pixels, mask, text, *args, **kwargs):
        n = pixels.shape[0] // 2
        out = real(self, pixels[:n], mask[:n], {k: v[:n] for k, v in text.items()},
                   *args, **kwargs)
        return {k: (torch.cat([v] * 2) if torch.is_tensor(v) and v.dim() else v)
                for k, v in out.items()}

    monkeypatch.setattr(GroundingDINO, "forward", half)
    out = run_cell("zira-t.serve-coco", monkeypatch, capsys)
    assert not out["correct"] and out["check"]["logit_gap"]["value"] > SERVE["logit_gap"]


def test_step_leaves_the_state_unchanged(monkeypatch, capsys):
    from ziragroundingdino_torch.train.optim import Optimizer

    def no_update(self):
        for p in self.params.values():
            p.grad = None
        return torch.zeros(())

    monkeypatch.setattr(Optimizer, "step", no_update)
    out = run_cell("zira-t.train-b8", monkeypatch, capsys)
    assert not out["correct"] and out["check"]["update_gap"]["value"] > 0.5
    assert out["check"]["unmoved"]["value"] > 0


def test_half_the_batch_trained(monkeypatch, capsys):
    """The step's loss over the first half of the batch, its mean over the
    rest."""
    import ziragroundingdino_torch.train.step as step

    real = step.compute_losses

    def half(model, batch, *args, **kwargs):
        n = batch["pixels"].shape[0] // 2
        return real(model, {k: v[:n] for k, v in batch.items()}, *args, **kwargs)

    monkeypatch.setattr(step, "compute_losses", half)
    out = run_cell("zira-t.train-b8", monkeypatch, capsys)
    assert not out["correct"] and out["check"]["loss_gap"]["value"] > TRAIN["loss_gap"]


def test_ranks_step_on_their_own_gradients(monkeypatch, capsys):
    """The data-parallel cell with the exchange of gradients left out: each
    rank's backward runs under DDP's `no_sync`, and the optimizer steps on
    its own rows' gradient."""
    import ziragroundingdino_torch.train.step as step

    from benchmark.tests.ranks import ranks_cell, run_ranks

    ranks_cell(monkeypatch)
    real = step.train_step

    def unaveraged(model, *args, **kwargs):
        with model.no_sync():
            return real(model, *args, **kwargs)

    monkeypatch.setattr(step, "train_step", unaveraged)
    assert run_ranks(2**31 + 21) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not out["correct"]
    assert out["check"]["rank_gap"]["value"] > 0
    assert out["check"]["grad_gap"]["value"] > TRAIN["grad_gap"]
