"""The ZiRa family's modules, train steps and merges against the JAX
package's, f32 on the CPU.

* Module by module, `RepZeroLinear` with the L1 ZIL, `RepZeroLoRA`,
  `RepZeroConvGN`, `RepZeroTransformerLayer` and `ZeroConvBN`, with the
  same seeded parameters (the conv modules at the 1x1 and the 3x3/s2
  projection shapes): the train and eval outputs and the ZIL (1e-5);
  `ZeroConvBN`'s running statistics moved as JAX's `apply(...,
  mutable=["batch_stats"])` moves them (1e-6); `rep_merge` and
  `rep_merge_convbn` of each (1e-6).
* Whole train steps at `tiny_config` for `repconvbngroundingdino`,
  `dualzerorepmultilayerbranchgroundingdino` and the LoRA language branch:
  every loss and the gradient of every trainable parameter at 1e-4 of its
  scale, both matchers pinned to JAX's assignments, as
  `tests/test_torch_train.py` holds the ZiRa preset. Then the whole model's
  `rep_merge` (and for repconvbn `rep_merge_convbn`) against JAX's, and for
  the exact reparameterisations (RepZeroConv, RepZeroLinear, LoRA) the merge
  algebra: train-mode detections before the merge equal eval-mode ones
  after it.
"""

import functools
import json
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_presets import preset_overrides
from tests.torch_common import TinyPair, assert_close, port_config, random_params, random_stats
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.models import zira as pzira
from ziragroundingdino_torch.models.layers import init_weights
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.weights import jax_params_to_state_dict
from ziragroundingdino_tpu.models import zira as jzira

MODULE_TOL = 1e-5  # one module: a conv or two matmuls and a norm, f32
STATS_TOL = 1e-6  # the running statistics: one multiply-add of a mean or a variance
MERGE_TOL = 1e-6  # one multiply-add per element (the BN fold: and one rsqrt)
STEP_TOL = 1e-4  # whole step, times each quantity's own largest magnitude
ALGEBRA_TOL = 1e-4  # whole forward: two matmuls against one, then 2 + 2 layers
# a gradient that is zero in exact arithmetic, times its layer's weight
# gradient's scale: f32 rounding of a sum over the map (5.8e-8 measured)
ZERO_GRAD_TOL = 1e-6

CIN, FEATURES, TOKENS = 16, 64, 7


def _t(x):
    return torch.from_numpy(np.array(x))


class _Holder(torch.nn.Module):
    """One module under the name the model gives it, so that the scaling
    resets and the weight bridge see the model's paths."""

    def __init__(self, name, module):
        super().__init__()
        if name == "input_proj_conv_adapter":
            self.input_proj_conv_adapter = torch.nn.ModuleList([module])
            self.path = "input_proj_conv_adapter.0"
        else:
            self.add_module(name, module)
            self.path = name

    @property
    def module(self):
        return self.get_submodule(self.path)


def _transformer_layer_sd(p, prefix):
    """The JAX RepZeroTransformerLayer's parameters as the port's state dict
    (no rule of the weight bridge maps them: no preset builds the layer)."""
    sd = {}
    attn = p["freeze_self_attn"]
    sd["freeze_self_attn.in_proj_weight"] = attn["in_proj_kernel"].T
    sd["freeze_self_attn.in_proj_bias"] = attn["in_proj_bias"]
    sd["freeze_self_attn.out_proj.weight"] = attn["out_proj"]["kernel"].T
    sd["freeze_self_attn.out_proj.bias"] = attn["out_proj"]["bias"]
    for n in ("freeze_norm1", "freeze_norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = p[n]["scale"], p[n]["bias"]
    for i in (1, 2):
        for side in ("freeze", "free"):
            sd[f"{side}_linear{i}.weight"] = p[f"{side}_linear{i}_kernel"].T
            sd[f"{side}_linear{i}.bias"] = p[f"{side}_linear{i}_bias"]
    return {f"{prefix}.{k}": _t(np.asarray(v, np.float32)).clone() for k, v in sd.items()}


# kind: (JAX module, port module, the model's name for it, input kind)
def _modules(kind, ks):
    stride = 2 if ks == 3 else 1
    if kind == "linear_l1":
        return (jzira.RepZeroLinear(features=FEATURES, scale_init=1.0, zil="l1"),
                pzira.RepZeroLinear(CIN, FEATURES, scale_init=1.0, zil="l1"),
                "rep_language_adapter", "tokens")
    if kind == "lora":
        return (jzira.RepZeroLoRA(features=FEATURES, down_dim=5),
                pzira.RepZeroLoRA(CIN, FEATURES, down_dim=5), "rep_linear_adapter", "tokens")
    if kind == "conv_gn":
        return (jzira.RepZeroConvGN(features=FEATURES, kernel_size=ks, stride=stride),
                pzira.RepZeroConvGN(CIN, FEATURES, ks, stride), "input_proj_conv_adapter", "map")
    if kind == "conv_bn":
        return (jzira.ZeroConvBN(features=FEATURES, kernel_size=ks, stride=stride),
                pzira.ZeroConvBN(CIN, FEATURES, ks, stride), "input_proj_conv_adapter", "map")
    return (jzira.RepZeroTransformerLayer(embed_dim=FEATURES, nhead=4, down_dim=32),
            pzira.RepZeroTransformerLayer(FEATURES, nhead=4, down_dim=32), "layer", "embedded")


MODULE_CASES = [("linear_l1", 1), ("lora", 1), ("conv_gn", 1), ("conv_gn", 3), ("conv_bn", 1),
                ("conv_bn", 3), ("transformer_layer", 1)]


class ModulePair:
    """A ZiRa module of both packages with the same seeded parameters (and
    statistics), and a seeded input with its token mask."""

    def __init__(self, kind, ks, seed=0):
        self.jmod, pmod, self.name, inp = _modules(kind, ks)
        rng = np.random.RandomState(seed)
        shape = {"tokens": (2, TOKENS, CIN), "map": (2, 9, 11, CIN),
                 "embedded": (2, TOKENS, FEATURES)}[inp]
        self.x = rng.randn(*shape).astype(np.float32)
        self.mask = np.arange(TOKENS)[None] < np.array([[TOKENS], [4]]) if inp == "tokens" \
            else None
        self.kw = {} if self.mask is None else {"mask": jnp.asarray(self.mask)}
        shapes = jax.eval_shape(functools.partial(self.jmod.init, train=True, **self.kw),
                                jax.random.PRNGKey(0), jnp.asarray(self.x))
        self.params = random_params(shapes["params"], seed)
        self.stats = random_stats(shapes["batch_stats"], seed) if "batch_stats" in shapes else {}
        self.port = _Holder(self.name, pmod)
        init_weights(self.port, torch.Generator().manual_seed(0))
        self.port.load_state_dict(self.state_dict(self.params, self.stats), strict=True)

    def state_dict(self, params, stats):
        """The JAX module's variables as the holder's state dict."""
        if self.name == "layer":
            return _transformer_layer_sd(params, "layer")
        path = self.name + ("_0" if self.name == "input_proj_conv_adapter" else "")
        return jax_params_to_state_dict({path: params}, {path: stats} if stats else None)

    def variables(self, params=None, stats=None):
        out = {"params": self.params if params is None else params}
        if self.stats:
            out["batch_stats"] = self.stats if stats is None else stats
        return out

    def port_kw(self):
        return {} if self.mask is None else {"mask": _t(self.mask)}


@pytest.mark.parametrize("kind, ks", MODULE_CASES)
def test_module_forward_matches_jax(kind, ks):
    """Train output and ZIL, and the eval output (the freeze branch alone),
    at 1e-5."""
    mp = ModulePair(kind, ks)
    x = jnp.asarray(mp.x)
    (jout, jzil) = mp.jmod.apply(mp.variables(), x, train=True, **mp.kw)
    jeval, _ = mp.jmod.apply(mp.variables(), x, train=False, **mp.kw)
    out, zil = mp.port.module.forward_train(_t(mp.x), **mp.port_kw())
    assert_close(out, jout, MODULE_TOL, what=f"{kind}: train output")
    np.testing.assert_allclose(zil.item(), float(jzil), rtol=MODULE_TOL, err_msg=f"{kind}: ZIL")
    assert_close(mp.port.module(_t(mp.x)), jeval, MODULE_TOL, what=f"{kind}: eval output")
    # the branch matters in train mode and not in eval
    assert np.abs(np.asarray(jout) - np.asarray(jeval)).max() > 1e-3


@pytest.mark.parametrize("ks", [1, 3])
def test_zeroconvbn_moves_its_statistics_as_jax(ks):
    """`forward_train(update_stats=True)` moves the running mean and
    variance as JAX's `apply(..., mutable=["batch_stats"])` (momentum 0.9,
    the batch's biased variance) at 1e-6; without it they stay as loaded,
    as in the JAX train step, which does not make them mutable."""
    mp = ModulePair("conv_bn", ks)
    before = {k: v.clone() for k, v in mp.port.state_dict().items()}
    mp.port.module.forward_train(_t(mp.x))
    for k, v in mp.port.state_dict().items():
        assert torch.equal(v, before[k]), k
    _, new = mp.jmod.apply(mp.variables(), jnp.asarray(mp.x), train=True,
                           mutable=["batch_stats"])
    mp.port.module.forward_train(_t(mp.x), update_stats=True)
    bn = mp.port.module.branch.bn
    stats = new["batch_stats"]
    assert_close(bn.running_mean, stats["bn_mean"], STATS_TOL, what="running_mean")
    assert_close(bn.running_var, stats["bn_var"], STATS_TOL, what="running_var")
    assert not torch.equal(bn.running_var, before["input_proj_conv_adapter.0.branch.bn.running_var"])


def _close_state_dicts(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        w = want[k].float()
        scale = max(1.0, w.abs().max().item())
        assert (got[k].float() - w).abs().max().item() <= tol * scale, f"{what}: {k}"


@pytest.mark.parametrize("kind, ks", MODULE_CASES)
def test_module_merge_matches_jax(kind, ks):
    """`rep_merge` of each module at 1e-6 against JAX's, with the default
    scaling resets (1.0 for the multilayer variant's modules, 0.1 else);
    ZeroConvBN is left alone by `rep_merge` in both packages and folded by
    `rep_merge_convbn`."""
    mp = ModulePair(kind, ks)
    path = mp.name + ("_0" if mp.name == "input_proj_conv_adapter" else "")
    before = {k: v.clone() for k, v in mp.port.state_dict().items()}
    merged = pzira.rep_merge(mp.port)
    want = jzira.rep_merge({path: mp.params})[path]
    if kind == "conv_bn":
        assert merged == []
        _close_state_dicts(mp.port.state_dict(), before, 0.0, "rep_merge on ZeroConvBN")
        merged = pzira.rep_merge_convbn(mp.port)
        want, want_stats = jzira.rep_merge_convbn({path: mp.params}, {path: mp.stats})
        want, stats = want[path], want_stats[path]
        assert np.all(np.asarray(stats["bn_var"]) == np.float32(1e-8))
    else:
        stats = None
    assert merged == [mp.port.path]
    got = mp.port.state_dict()
    _close_state_dicts(got, mp.state_dict(want, stats), MERGE_TOL, kind)
    assert any(not torch.equal(got[k], before[k]) for k in got if "freeze" in k)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

STEP_CASES = ("repconvbn", "multilayer", "lora")


@pytest.fixture(scope="module", params=STEP_CASES)
def step_setup(request):
    """A preset's tiny pair at the weights of seed 1, the batch, JAX's
    train-mode assignments (its matcher on its outputs), and JAX's losses
    and gradients with its matcher pinned to them (`test_torch_train.py::
    _jax_step`, with the preset's variables)."""
    from tests.test_train_step import make_batch
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train import matcher as jmatch
    from ziragroundingdino_tpu.train.step import class_logits_from_tokens, compute_losses

    tp = TinyPair(seed=1, **preset_overrides(request.param))
    batch = make_batch()
    text = {k: batch[k] for k in pstep.TEXT_KEYS}
    out = jax.jit(lambda v: tp.jmodel.apply(v, batch["pixels"], batch["mask"], text,
                                            train=True))(tp.variables())
    c2t = batch["cate_to_token_mask"]
    heads = [out] + list(out["aux_outputs"]) + [out["interm_outputs"]]
    assignments = [np.asarray(jmatch.match_batch(
        class_logits_from_tokens(o["pred_logits"], c2t), o["pred_boxes"], batch["gt_labels"],
        batch["gt_boxes"], batch["gt_valid"])) for o in heads]
    order = iter(assignments)
    orig = jcrit.match_batch
    jcrit.match_batch = lambda *a, **k: jnp.asarray(next(order))
    try:
        (_, losses), grads = jax.jit(jax.value_and_grad(
            lambda p: compute_losses(tp.jmodel, tp.variables(p), batch, train=True),
            has_aux=True))(tp.params)
    finally:
        jcrit.match_batch = orig
    return request.param, tp, batch, assignments, losses, grads


def _trainable_model(tp):
    model = build_model(port_config(tp.cfg), device="cpu", dtype="float32")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(model.cfg))
    return model


def _pin(monkeypatch, assignments):
    order = iter(assignments)
    monkeypatch.setattr(pcrit, "match_batch", lambda *a, **k: _t(next(order)).long())


def _broadcast(mask, params):
    if isinstance(mask, Mapping):
        return {k: _broadcast(mask[k], params[k]) for k in mask}
    return np.full(np.shape(params), bool(mask))


def test_preset_train_step_matches_jax(step_setup, monkeypatch):
    """The preset's loss dict (its ZILs as the JAX step gates them) and the
    gradient of every trainable parameter (JAX's trainable set: every
    "adapter" parameter, the freeze branches and `freeze_gn` included, no
    BN statistics) at 1e-4 of each one's magnitude."""
    from ziragroundingdino_tpu.train.optim import trainable_mask

    case, tp, batch, assignments, want_losses, want_grads = step_setup
    model = _trainable_model(tp)
    mask = jax_params_to_state_dict(_broadcast(trainable_mask(tp.params, ("adapter",)),
                                               tp.params))
    want_set = {k for k, v in mask.items() if bool(v.all())}
    got_set = {n for n, p in model.named_parameters() if p.requires_grad}
    assert got_set == want_set and len(got_set) == {"repconvbn": 24, "multilayer": 33,
                                                    "lora": 24}[case]
    _pin(monkeypatch, assignments)
    total, losses = pstep.compute_losses(model, {k: _t(v).clone() for k, v in batch.items()})
    total.backward()
    assert sorted(losses) == sorted(want_losses)
    want_adapters = {"repconvbn": {"loss_conv_adapter"},
                     "multilayer": {"loss_conv_adapter", "loss_linear_adapter"},
                     "lora": {"loss_conv_adapter", "loss_linear_adapter"}}[case]
    assert {k for k in losses if "adapter" in k} == want_adapters
    loss_err = {k: abs(losses[k].item() - float(v)) / max(abs(float(v)), 1e-30)
                for k, v in want_losses.items()}
    want = {n: v.numpy() for n, v in jax_params_to_state_dict(want_grads).items()}
    grad_err, zero_grads = {}, {}
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, n
            continue
        g = p.grad.numpy()
        if n.endswith("branch.conv.bias"):
            # a bias that a batch-statistics BatchNorm follows has a zero
            # gradient in exact arithmetic (the mean takes it away): both
            # packages' values are rounding, held against the scale of the
            # conv weight's gradient
            scale = np.abs(want[n.replace(".bias", ".weight")]).max()
            zero_grads[n] = max(np.abs(g).max(), np.abs(want[n]).max()) / scale
            continue
        grad_err[n] = np.abs(g - want[n]).max() / max(np.abs(want[n]).max(), 1e-30)
    assert len(zero_grads) == (4 if case == "repconvbn" else 0)
    assert max(loss_err.values()) <= STEP_TOL, loss_err
    assert max(grad_err.values()) <= STEP_TOL, grad_err
    assert max(zero_grads.values(), default=0.0) <= ZERO_GRAD_TOL, zero_grads


def test_preset_rep_merge_matches_jax(step_setup):
    """The whole model's merge with the config's scaling resets against the
    JAX package's `rep_merge` (and for repconvbn its `rep_merge_convbn`,
    which the lifecycle does not call) at 1e-6; every tensor outside the
    ZiRa branches unchanged."""
    case, tp = step_setup[:2]
    model = _trainable_model(tp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    merged = pzira.rep_merge(model, scale_reset=pzira.scale_reset_for_cfg(model.cfg))
    want = jzira.rep_merge(tp.params, scale_reset=jzira.scale_reset_for_cfg(tp.cfg))
    stats = tp.stats
    if case == "repconvbn":
        assert merged == []
        merged = pzira.rep_merge_convbn(model)
        want, stats = jzira.rep_merge_convbn(want, tp.stats)
    n_lang = 0 if case == "repconvbn" else 1
    assert len(merged) == n_lang + tp.cfg.num_feature_levels
    got = model.state_dict()
    _close_state_dicts(got, jax_params_to_state_dict(want, stats), MERGE_TOL, case)
    for k, v in got.items():
        if "adapter" not in k:
            assert torch.equal(v, before[k]), k


def _detections(model, tp, train):
    with torch.no_grad():
        out = model(_t(tp.pixels), _t(tp.mask), {k: _t(v) for k, v in tp.tb.asdict().items()},
                    train=train)
    return out


@pytest.mark.parametrize("case", ["repgroundingdino", "lora"])
def test_merge_is_exact_for_the_repconv_and_lora_branches(case, monkeypatch):
    """For RepZeroConv, RepZeroLinear and RepZeroLoRA the merge is an exact
    reparameterisation: deterministic train-mode detections before it equal
    eval-mode detections after it (1e-4; the query selection of the first
    pinned on the second), while the branches change them."""
    from ziragroundingdino_torch.models import transformer as ptransformer

    tp = TinyPair(seed=2, **preset_overrides(case))
    model = _trainable_model(tp)
    before = _detections(model, tp, True)
    unmerged = _detections(model, tp, False)
    pzira.rep_merge(model, scale_reset=pzira.scale_reset_for_cfg(model.cfg))
    monkeypatch.setattr(ptransformer, "select_topk", lambda s, k: before["topk_idx"])
    after = _detections(model, tp, False)
    for k in ("pred_logits", "pred_boxes", "encoded_text"):
        assert_close(after[k], before[k].numpy(), ALGEBRA_TOL, what=k)
    # the branches matter: without the merge, eval mode misses them
    assert (unmerged["pred_logits"] - before["pred_logits"]).abs().max() > 10 * ALGEBRA_TOL


# ---------------------------------------------------------------------------
# the lifecycle driver
# ---------------------------------------------------------------------------

LIFECYCLE_CASES = {  # case: (preset, model overrides)
    "repgroundingdino": ("repgroundingdino", {}),
    "multilayer": ("dualzerorepmultilayerbranchgroundingdino", {}),
    "repconvbn": ("repconvbngroundingdino", {}),
    "lora": ("dualzerorepbranchgroundingdino", {"zira_lan_adapter": "lora"}),
}


@pytest.fixture(scope="module")
def vanilla_odinw(tmp_path_factory):
    """A tiny vanilla `groundingdino` checkpoint (no ZiRa key) with a
    prompt-memory entry, a vocab and the two synthetic ODinW tasks of
    `tests/test_torch_trainer.py`."""
    from tests.common import tiny_tokenizer
    from tests.test_torch_trainer import DATA, TASKS, TINY_MODEL
    from ziragroundingdino_torch.config import load_config_overrides
    from ziragroundingdino_torch.data.synthetic import write_odinw_task, write_vocab

    root = tmp_path_factory.mktemp("vanilla_odinw")
    (root / "ov.json").write_text(json.dumps({"model": TINY_MODEL, "data": DATA}))
    model = build_model("groundingdino", device="cpu", seed=0,
                        **load_config_overrides(str(root / "ov.json"))[0])
    sd = dict(model.state_dict())
    sd["prompt_memory_pool.-fish-"] = torch.randn(2, 64, generator=torch.Generator().manual_seed(0))
    torch.save({"model": sd}, root / "ckpt.pth")
    write_vocab(str(root / "vocab.txt"), tiny_tokenizer().vocab)
    for i, (name, classes) in enumerate(TASKS.items()):
        write_odinw_task(str(root / "data"), name, classes, 4, 3, (96, 128), seed=10 * i)
    return root, TASKS, TINY_MODEL, DATA


@pytest.mark.parametrize("case", sorted(LIFECYCLE_CASES))
def test_lifecycle_driver_trains_and_merges_each_preset(case, vanilla_odinw, tmp_path):
    """`train_odinw --preset <preset>` from the vanilla checkpoint: two tasks
    of 2 steps, 2 replay iterations, the eval. After each task every tensor
    outside the ZiRa branches is the checkpoint's; each branch with a
    scaling is folded (freeze = trained freeze + scaling * branch, or the
    LoRA product) and reset (scaling to the preset's init: 1.0 for the
    multilayer variant, 0.1 else); a ZeroConvBN branch is not folded and
    its statistics stay as loaded, as in the JAX lifecycle."""
    from ziragroundingdino_torch.scripts import train_odinw

    root, tasks, tiny_model, data = vanilla_odinw
    preset, extra = LIFECYCLE_CASES[case]
    (tmp_path / "ov.json").write_text(json.dumps({"model": dict(tiny_model, **extra),
                                                  "data": data}))
    out = tmp_path / "out"
    report = train_odinw.main([
        "--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
        "--datasets-root", str(root / "data"), "--tasks", ",".join(tasks),
        "--output-dir", str(out), "--batch-size", "2", "--max-iter", "2",
        "--checkpoint-period", "2", "--replay-iters", "2", "--preset", preset,
        "--config-overrides", str(tmp_path / "ov.json"), "--device", "cpu"])
    assert set(report) == {f"AP/{n}" for n in tasks} | {"avg_AP"}
    assert all(np.isfinite(v) for v in report.values())

    before = torch.load(root / "ckpt.pth", weights_only=True)["model"]
    for name in tasks:
        params = torch.load(out / name / "state_final.pt", weights_only=True)["params"]
        trained = torch.load(out / name / "ckpt" / "step_2.pt", weights_only=True)["model"]
        for k, v in params.items():
            if "adapter" not in k:
                assert torch.equal(v, before[k]), (name, k)
        model = build_model(preset, device="cpu", **_overrides(tmp_path / "ov.json"))
        model.load_state_dict(trained)
        for mname, mod in model.named_modules():
            if isinstance(mod, pzira.ZeroConvBN):
                for k in [k for k in params if k.startswith(mname + ".")]:
                    assert torch.equal(params[k], trained[k]), k
                assert torch.all(params[f"{mname}.branch.bn.running_var"] == pzira.ZERO_VALUE)
                continue
            if not isinstance(mod, (pzira.RepZeroLoRA,) + pzira.REP_MODULES):
                continue
            s = trained[f"{mname}.scaling"]
            if isinstance(mod, pzira.RepZeroLoRA):
                parts = {"freeze_linear.weight": s * (trained[f"{mname}.up.weight"]
                                                      @ trained[f"{mname}.down.weight"])}
            else:
                freeze = "freeze_linear" if isinstance(mod, pzira.RepZeroLinear) else "freeze_conv"
                parts = {f"{freeze}.{p}": s * trained[f"{mname}.{p}"] for p in ("weight", "bias")}
            for k, delta in parts.items():
                want = trained[f"{mname}.{k}"] + delta
                torch.testing.assert_close(params[f"{mname}.{k}"], want, atol=MERGE_TOL, rtol=0)
            init = 1.0 if case == "multilayer" else 0.1
            assert torch.all(params[f"{mname}.scaling"] == init), mname
        before = params


def _overrides(path):
    from ziragroundingdino_torch.config import load_config_overrides

    return load_config_overrides(str(path))[0]
