"""Remat and the ResNet finetune step, f32 on the CPU.

Remat (`models/remat.py`) under the step's explicit generator: with every
dropout and drop-path rate above 0 and one generator seed, a step with
Swin's `use_checkpoint`, `use_checkpoint` and `use_transformer_ckpt` gives
bitwise the losses and gradients of a step without, recomputes each
checkpointed layer once in the backward, and leaves the generator as the
step without does; a checkpoint that ignores the generator would not. The
remat step against JAX's remat step, and a ResNet `finetune` step (learned
positions) against JAX's, at the tolerances of `tests/test_torch_train.py`.
Last, the SLConfig shim on a Swin-B config file against JAX's, and the
entry points' `--config-overrides` and `train_odinw`'s remat default.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests.common import TINY_BERT, TINY_SWIN, tiny_config
from tests.test_torch_train import STEP_TOL, _broadcast, _jax_step, _step_errors, _torch_batch
from tests.test_torch_trainer import odinw  # noqa: F401  (the tiny checkpoint and tasks)
from tests.torch_common import pinned_matcher, port_config
from ziragroundingdino_torch.models import build_model, swin, transformer
from ziragroundingdino_torch.models.fusion import BiAttentionBlock
from ziragroundingdino_torch.models.swin import SwinBlock
from ziragroundingdino_torch.models.transformer import DeformableEncoderLayer
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.weights import jax_params_to_state_dict

# every rate above 0: Swin's drop path, BERT's, the fusion layers' and the
# text and decoder attention dropout
DROPOUT = dict(dropout=0.1, text_dropout=0.1, fusion_dropout=0.1, fusion_droppath=0.1,
               bert_config=dataclasses.replace(TINY_BERT, hidden_dropout=0.1,
                                               attention_dropout=0.1))
CHECKPOINTED = (SwinBlock, BiAttentionBlock, DeformableEncoderLayer)
# the `finetune` preset's switches over the tiny config
FINETUNE = dict(modelname="dtgroundingdino", freeze_all=False, use_cet=False,
                use_zero_inter_loss=False, use_project_adapter=False,
                use_zero_inter_loss_for_conv=False)


def _config(remat: bool):
    return port_config(tiny_config(
        **DROPOUT, use_checkpoint=remat, use_transformer_ckpt=remat,
        swin_config=dataclasses.replace(TINY_SWIN, drop_path_rate=0.1, use_checkpoint=remat)))


@pytest.fixture(scope="module")
def batch():
    from tests.test_train_step import make_batch

    return _torch_batch(make_batch())


def _step(remat: bool, batch, grad: bool = True):
    """One step's losses, every parameter's gradient (all train, so the
    backward reaches Swin), the generator's state after it, and how often
    each checkpointed kind of layer ran."""
    model = build_model(_config(remat), device="cpu", dtype="float32", seed=3)
    poptim.set_trainable(model, (), freeze_all=False)
    calls = {cls.__name__: 0 for cls in CHECKPOINTED}
    for m in model.modules():
        if isinstance(m, CHECKPOINTED):
            # a pre-hook: a recompute may stop before the layer returns
            m.register_forward_pre_hook(
                lambda mod, args: calls.__setitem__(type(mod).__name__,
                                                    calls[type(mod).__name__] + 1))
    gen = torch.Generator().manual_seed(5)
    with torch.set_grad_enabled(grad):
        total, losses = pstep.compute_losses(model, batch, gen)
    if grad:
        total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return losses, grads, gen.get_state(), calls


@pytest.fixture(scope="module")
def plain_step(batch):
    return _step(False, batch)


def test_remat_is_exact_under_a_generator(plain_step, batch):
    losses, grads, state, calls = plain_step
    r_losses, r_grads, r_state, r_calls = _step(True, batch)
    assert calls == {"SwinBlock": 4, "BiAttentionBlock": 2, "DeformableEncoderLayer": 2}
    assert r_calls == {k: 2 * v for k, v in calls.items()}  # each recomputed once
    assert losses.keys() == r_losses.keys()
    for k in losses:
        assert torch.equal(losses[k], r_losses[k]), k
    assert all(g is not None for g in grads.values())
    for n in grads:
        assert torch.equal(grads[n], r_grads[n]), n
    assert torch.equal(state, r_state)


def test_a_checkpoint_blind_to_the_generator_differs(plain_step, batch, monkeypatch):
    """The control: the same step with the helper given no generator (a
    plain `torch.utils.checkpoint`) draws other masks in the recompute, and
    the gradients differ."""
    from ziragroundingdino_torch.models import remat

    def blind(fn, *args, generator=None):
        return remat.checkpoint(fn, *args)

    monkeypatch.setattr(swin, "checkpoint", blind)
    monkeypatch.setattr(transformer, "checkpoint", blind)
    losses, grads, _, _ = plain_step
    b_losses, b_grads, _, _ = _step(True, batch)
    assert torch.equal(losses["total_loss"], b_losses["total_loss"])  # the forward is the same
    assert any(not torch.equal(grads[n], b_grads[n]) for n in grads)


def test_remat_runs_once_without_autograd(plain_step, batch):
    """With autograd off (as in eval and serving), remat is the plain
    forward: one call a layer, the same losses."""
    losses, _, _, calls = plain_step
    r_losses, _, _, r_calls = _step(True, batch, grad=False)
    assert r_calls == calls
    for k in losses:
        assert torch.equal(losses[k], r_losses[k]), k


def test_remat_train_step_matches_jax(monkeypatch):
    """The ZiRa step with `use_checkpoint` and `use_transformer_ckpt` against
    JAX's step with the same switches (`nn.remat`), the matcher pinned to
    JAX's assignments: every loss and trainable gradient at STEP_TOL."""
    setup = _jax_step(1, use_checkpoint=True, use_transformer_ckpt=True)
    assert setup[0].cfg.use_checkpoint and setup[0].cfg.use_transformer_ckpt
    loss_err, grad_err, _, _ = _step_errors(setup, monkeypatch)
    assert max(loss_err.values()) <= STEP_TOL, loss_err
    assert max(grad_err.values()) <= STEP_TOL, grad_err


# BERT's attention key biases: their gradient is 0 by construction (a
# softmax does not see a shift that is the same for every key), so both
# packages give f32 noise there
ZERO_GRADIENT = ".attention.self.key.bias"
ZERO_GRADIENT_TOL = 1e-5  # largest |gradient| of those noise entries


def test_resnet_finetune_step_matches_jax(monkeypatch):
    """`finetune` (every parameter trains) on ResNet-50 with learned
    positions: the frozen BN's weight, bias, running mean and variance and
    the learned tables train, as in JAX (`trainable_mask(freeze_all=False)`
    there). Every loss and every gradient against JAX's at STEP_TOL (but
    `ZERO_GRADIENT`'s), then one optimizer step moves the BN tensors and
    the tables. At the weights of seed 4: with all of ResNet's ReLUs in
    the gradient's path, at seeds 0-2 one of their inputs (or one of the
    encoder FFN's: 2.1e-6 at seed 1) lies within the f32 gap between the
    two packages, and the gradients behind that kink differ by up to 5e-2
    of their scale; seeds 3 and 4 meet JAX at 3e-5 everywhere."""
    from ziragroundingdino_tpu.train.optim import trainable_mask

    tp, batch, assignments, want_losses, want_grads = _jax_step(
        4, backbone="resnet50", position_embedding="learned", **FINETUNE)
    model = build_model(port_config(tp.cfg), device="cpu", dtype="float32")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(model.cfg),
                         freeze_all=model.cfg.freeze_all)
    jmask = jax_params_to_state_dict(
        _broadcast(trainable_mask(tp.params, ("adapter",), freeze_all=False), tp.params))
    assert all(bool(v.all()) for v in jmask.values())
    params = dict(model.named_parameters())
    assert all(p.requires_grad for p in params.values())
    # the frozen BN's tensors: 53 BNs (the stem's, 3 a block, 4 downsamples)
    bn = [n for n in params if n.startswith("backbone.0.body.")
          and "conv" not in n and "downsample.0" not in n]
    tables = ["backbone.1.row_embed.weight", "backbone.1.col_embed.weight"]
    assert len(bn) == 4 * 53 and set(tables) <= set(params)

    monkeypatch.setattr(pcrit, "match_batch", pinned_matcher(iter(assignments)))
    total, losses = pstep.compute_losses(model, _torch_batch(batch))
    total.backward()
    for k, v in want_losses.items():
        assert abs(losses[k].item() - float(v)) <= STEP_TOL * max(abs(float(v)), 1e-30), k
    want = {n: v.numpy() for n, v in jax_params_to_state_dict(want_grads).items()}
    errs = {n: np.abs(p.grad.numpy() - want[n]).max() / max(np.abs(want[n]).max(), 1e-30)
            for n, p in params.items() if ZERO_GRADIENT not in n}
    assert max(errs.values()) <= STEP_TOL, {n: e for n, e in errs.items() if e > STEP_TOL}
    zero = [n for n in params if ZERO_GRADIENT in n]
    assert len(zero) == tp.cfg.bert.num_hidden_layers
    for n in zero:
        assert max(np.abs(want[n]).max(), params[n].grad.abs().max().item()) <= ZERO_GRADIENT_TOL
    for n in bn + tables:
        assert np.abs(want[n]).max() > 0, n

    before = {n: params[n].detach().clone() for n in bn + tables}
    opt = poptim.Optimizer(model, poptim.OptimizerConfig(lr=1e-2), poptim.ScheduleConfig())
    opt.step()
    assert all(not torch.equal(params[n], before[n]) for n in bn + tables)


def test_slconfig_matches_jax(tmp_path):
    """A GroundingDINO-B config file (the reference's `GroundingDINO_SwinB_cfg.py`
    knobs) through both shims: the same value in every field of the
    port's config; the port ignores what JAX ignores, and the knobs of
    JAX's fields that no code reads."""
    from ziragroundingdino_tpu.utils.slconfig import config_from_slconfig as jax_shim
    from ziragroundingdino_torch.utils.slconfig import config_from_slconfig

    f = tmp_path / "GroundingDINO_SwinB_cfg.py"
    f.write_text(
        "batch_size = 1\n"
        "modelname = 'groundingdino'\n"
        "backbone = 'swin_B_384_22k'\n"
        "position_embedding = 'sine'\n"
        "pe_temperatureH = 20\n"
        "pe_temperatureW = 20\n"
        "return_interm_indices = [1, 2, 3]\n"
        "backbone_freeze_keywords = None\n"
        "enc_layers = 6\n"
        "dec_layers = 6\n"
        "pre_norm = False\n"
        "dim_feedforward = 2048\n"
        "hidden_dim = 256\n"
        "dropout = 0.0\n"
        "nheads = 8\n"
        "num_queries = 900\n"
        "query_dim = 4\n"
        "num_patterns = 0\n"
        "num_feature_levels = 4\n"
        "enc_n_points = 4\n"
        "dec_n_points = 4\n"
        "two_stage_type = 'standard'\n"
        "two_stage_bbox_embed_share = False\n"
        "two_stage_class_embed_share = False\n"
        "transformer_activation = 'relu'\n"
        "dec_pred_bbox_embed_share = True\n"
        "dn_box_noise_scale = 1.0\n"
        "dn_label_noise_ratio = 0.5\n"
        "dn_label_coef = 1.0\n"
        "dn_bbox_coef = 1.0\n"
        "embed_init_tgt = True\n"
        "dn_labelbook_size = 2000\n"
        "max_text_len = 256\n"
        "text_encoder_type = 'bert-base-uncased'\n"
        "use_text_enhancer = True\n"
        "use_fusion_layer = True\n"
        "use_checkpoint = True\n"
        "use_transformer_ckpt = True\n"
        "use_text_cross_attention = True\n"
        "text_dropout = 0.0\n"
        "fusion_dropout = 0.0\n"
        "fusion_droppath = 0.1\n"
        "sub_sentence_present = True\n"
    )
    cfg, ignored = config_from_slconfig(str(f))
    jcfg, jignored = jax_shim(str(f))
    for field in dataclasses.fields(cfg):
        assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
    assert cfg.backbone == "swin_B_384_22k" and cfg.swin.window_size == 12
    assert cfg.use_checkpoint and cfg.use_transformer_ckpt and cfg.return_interm_indices == (1, 2, 3)
    assert set(jignored) <= set(ignored)
    assert set(ignored) - set(jignored) == {
        "query_dim", "num_patterns", "two_stage_type", "two_stage_bbox_embed_share",
        "dec_pred_bbox_embed_share", "text_encoder_type"}


@pytest.mark.parametrize("no_remat", [False, True])
def test_entry_points_take_overrides_and_train_odinw_remats(odinw, tmp_path, monkeypatch,
                                                           no_remat):
    """`--config-overrides` reaches the model that `train_odinw`, `eval_coco`
    and the demo build (here learned positions over the tiny model), and
    `train_odinw` trains with remat unless `--no-remat`, as JAX's does."""
    from tests.test_torch_trainer import DATA, TASKS, TINY_MODEL, _main
    from ziragroundingdino_torch.scripts import eval_coco, inference_on_a_image
    from ziragroundingdino_torch.utils import inference

    ov = tmp_path / "learned.json"
    ov.write_text(json.dumps({"model": dict(TINY_MODEL, position_embedding="learned"),
                              "data": DATA}))
    built = []
    load_model = inference.load_model
    monkeypatch.setattr(inference, "load_model",
                        lambda *a, **k: built.append(load_model(*a, **k)) or built[-1])
    extra = ["--config-overrides", str(ov)] + (["--no-remat"] if no_remat else [])
    report = _main(odinw, tmp_path / "out", *extra)
    assert set(report) == {f"AP/{t}" for t in TASKS} | {"avg_AP"}
    cfg = built[0].cfg
    assert (cfg.use_checkpoint, cfg.use_transformer_ckpt) == (not no_remat, not no_remat)
    assert cfg.position_embedding == "learned"
    assert "backbone.1.row_embed.weight" in built[0].missing  # the checkpoint has sine positions
    if no_remat:
        return
    split = odinw / "data" / "CottontailRabbits" / "test"
    eval_coco.main(["--checkpoint", str(odinw / "ckpt.pth"), "--vocab", str(odinw / "vocab.txt"),
                    "--json", str(split / "annotations_without_background.json"),
                    "--image-root", str(split), "--max-images", "1", "--config-overrides",
                    str(ov), "--device", "cpu", "--output", str(tmp_path / "eval.json")])
    image = next(split.glob("*.ppm"))
    inference_on_a_image.main(["-p", str(odinw / "ckpt.pth"), "--vocab", str(odinw / "vocab.txt"),
                               "-i", str(image), "-t", "cat . dog .", "-o", str(tmp_path / "demo"),
                               "--config-overrides", str(ov), "--device", "cpu"])
    assert [lm.cfg.position_embedding for lm in built[1:]] == ["learned", "learned"]
    assert not any(lm.cfg.use_checkpoint for lm in built[1:])  # remat is train_odinw's
