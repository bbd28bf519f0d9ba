"""The PET baselines and CAT through `load_model` and the ODinW driver,
against the JAX package where it reads the same file, f32 on the CPU.

* Reference-format checkpoints of `dtgroundingdino`, `catgroundingdino`
  and `linearprobe` load into their presets with nothing missing,
  unexpected or mismatched (the CAT checkpoint also into the JAX
  package's `load_model`, with the same detections), and the vanilla
  checkpoint loads into each with exactly the preset's own tensors
  missing.
* `train_odinw --preset <each of the seven> --device cpu` from a vanilla
  checkpoint, two tasks of 2 steps, 2 replay iterations, the eval: every
  tensor outside the preset's trainable set unchanged, the trainable ones
  moved.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pet import preset_overrides
from tests.test_torch_pet_train import PRESETS, port_trainable
from tests.test_torch_presets_train import vanilla_odinw  # noqa: F401  (a fixture)
from tests.torch_common import TinyPair, port_config, torch_text
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.train import optim as poptim


@pytest.mark.parametrize("preset", PRESETS)
def test_driver_trains_each_preset(preset, vanilla_odinw, tmp_path):
    """`train_odinw --preset <preset>` from the vanilla checkpoint (two tasks
    of 2 steps, 2 replay iterations, the eval): a finite report; after each
    task every tensor outside the preset's trainable set as the chain left
    it and, but for prompttune, some trainable tensor moved. The dt model
    adds learned names to its captions (`use_add_names`)."""
    from ziragroundingdino_torch.config import load_config_overrides
    from ziragroundingdino_torch.scripts import train_odinw

    root, tasks, tiny_model, data = vanilla_odinw
    (tmp_path / "ov.json").write_text(json.dumps({"model": tiny_model, "data": data}))
    out = tmp_path / "out"
    report = train_odinw.main([
        "--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
        "--datasets-root", str(root / "data"), "--tasks", ",".join(tasks),
        "--output-dir", str(out), "--batch-size", "2", "--max-iter", "2",
        "--checkpoint-period", "2", "--replay-iters", "2", "--preset", preset,
        "--config-overrides", str(tmp_path / "ov.json"), "--device", "cpu"])
    assert set(report) == {f"AP/{n}" for n in tasks} | {"avg_AP"}
    assert all(np.isfinite(v) for v in report.values())

    model = build_model(preset, device="cpu", **load_config_overrides(str(tmp_path / "ov.json"))[0])
    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(model.cfg),
                         freeze_all=model.cfg.freeze_all)
    trainable = port_trainable(model)
    before = torch.load(root / "ckpt.pth", weights_only=True)["model"]
    for name in tasks:
        params = torch.load(out / name / "state_final.pt", weights_only=True)["params"]
        moved = set()
        for k, v in params.items():
            if k not in before:  # the preset's own modules: at their init in the first task
                continue
            if k in trainable:
                moved |= {k} if not torch.equal(v, before[k]) else set()
            else:
                assert torch.equal(v, before[k]), (name, k)
        if preset not in ("prompttune",) and any(k in before for k in trainable):
            assert moved, name
        before = params


# ---------------------------------------------------------------------------
# reference-format checkpoints of the new presets through `load_model`
# ---------------------------------------------------------------------------

# the preset's own tensors, which a vanilla checkpoint lacks
OWN_KEYS = {"dtgroundingdino": ("cet_adapter.",),
            "catgroundingdino": ("prompt_adapter.", ".adapter."),
            "linearprobe": ("cls_linear",)}


@pytest.mark.parametrize("preset", sorted(OWN_KEYS))
def test_load_model_takes_reference_checkpoints(preset, vanilla_odinw, tmp_path, monkeypatch):
    """A reference-format checkpoint of the preset (`module.`-prefixed, the
    MoE's `mean`/`std` buffers and every alias of the shared heads
    included) loads with nothing missing, unexpected or mismatched and
    serves what the model it came from serves; for CAT the JAX package's
    `load_model` reads the same file and detects the same at 1e-4. The
    vanilla checkpoint loads into the preset with exactly the preset's own
    tensors missing (kept at their init) and nothing unexpected."""
    from tests.test_torch_presets import TINY_FIELDS
    from ziragroundingdino_torch.utils import inference as pinf

    root = vanilla_odinw[0]
    tp = TinyPair(seed=0, **preset_overrides(preset))
    pov = {k: getattr(port_config(tp.cfg), k) for k in TINY_FIELDS}
    sd = tp.port.state_dict()
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / "ckpt.pth")
    vocab = str(root / "vocab.txt")
    lm = pinf.load_model(str(tmp_path / "ckpt.pth"), vocab, preset=preset, device="cpu", **pov)
    assert not (lm.missing or lm.unexpected or lm.mismatched)
    for k, v in lm.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    args = (torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask), torch_text(tp.tb))
    with torch.inference_mode():
        got, want = lm.model(*args), tp.port(*args)
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    if preset == "catgroundingdino":
        from ziragroundingdino_tpu.models.groundingdino import GroundingDINO
        from ziragroundingdino_tpu.utils import inference as jinf

        class JitInit(GroundingDINO):
            def init(self, *a):
                return jax.jit(super().init)(*a)

        monkeypatch.setattr(jinf, "GroundingDINO", JitInit)
        jlm = jinf.load_model(str(tmp_path / "ckpt.pth"), vocab, preset=preset,
                              **{k: getattr(tp.cfg, k) for k in TINY_FIELDS})
        jout = jax.jit(jlm.model.apply)(jlm.params, jnp.asarray(tp.pixels),
                                        jnp.asarray(tp.mask), tp.text)
        for k in ("pred_logits", "pred_boxes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jout[k]), atol=1e-4, rtol=0,
                                       err_msg=k)

    vanilla = pinf.load_model(str(root / "ckpt.pth"), vocab, preset=preset, device="cpu", **pov)
    own = sorted(k for k in sd if any(p in k for p in OWN_KEYS[preset]))
    assert own and sorted(vanilla.missing) == own
    assert not vanilla.unexpected and not vanilla.mismatched
