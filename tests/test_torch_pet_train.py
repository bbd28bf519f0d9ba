"""The PET baselines and CAT in training, against the JAX package, f32 on
the CPU.

* Trainable sets: for each of the seven presets, the port's trainable
  parameters (`set_trainable(patterns, freeze_all)`) are JAX's
  `trainable_mask` carried through the weight bridge: the CET adapter
  (dt), the heads' `cls_linear` and box heads (linearprobe), BERT and
  `feat_map` (berttune), the input projections (projecttune), the in-layer
  and prompt adapters (CAT), every parameter (finetune) and none
  (prompttune).
* One train step per preset at `tiny_config` (the weights of seed 1, no
  dropout): every loss (CAT's `loss_adapter` included) and the gradient of
  every trainable parameter at 1e-4 of its scale, the port's matcher pinned
  to the assignments JAX's matcher made inside its step. Presets that share
  an architecture and differ only in what trains (finetune, prompttune,
  berttune, projecttune) share one JAX gradient of every parameter.
  `prompttune` trains nothing: its step, as JAX's, computes the losses and
  leaves every weight bitwise as it was.
* A model that served a request can then train Swin (`finetune`).

`tests/test_torch_pet_driver.py` runs these presets through `load_model`
and the ODinW driver.
"""

from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_pet import preset_overrides
from tests.torch_common import TinyPair, architecture, pinned_matcher, port_config
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.weights import jax_params_to_state_dict

STEP_TOL = 1e-4  # whole step, times each quantity's own largest magnitude
# BERT's attention key biases shift every logit of a softmax row alike, so
# their gradient is 0 in exact arithmetic (finetune: 2.6e-6 of the key
# weight's) and both packages return rounding: held at STEP_TOL of the key
# weight gradient's scale
ZERO_IN_EXACT = "attention.self.key.bias"
# the fusion layers' image value bias sums every image token's gradient to
# 1.6e-3 of its weight's (finetune); f32 summation order leaves 0.80e-4 to
# 1.14e-4 of its own scale with 1 to 3 CPU threads, so it is held there at
# this tolerance
FUSION_V_BIAS = ("transformer.encoder.fusion_layers.", ".attn.v_proj.bias")
FUSION_V_BIAS_TOL = 3e-4

PRESETS = ("dtgroundingdino", "finetune", "linearprobe", "prompttune", "berttune",
           "projecttune", "catgroundingdino")
# trainable tensors of each preset at the tiny config (aliases of the shared
# heads counted once)
N_TRAINABLE = {"dtgroundingdino": 5, "finetune": 298, "linearprobe": 16, "prompttune": 0,
               "berttune": 39, "projecttune": 16, "catgroundingdino": 26}


def _t(x):
    return torch.from_numpy(np.array(x))


def _broadcast(mask, params):
    if isinstance(mask, Mapping):
        return {k: _broadcast(mask[k], params[k]) for k in mask}
    return np.full(np.shape(params), bool(mask))


def jax_trainable(tp):
    """The port names of JAX's trainable leaves (every alias)."""
    from ziragroundingdino_tpu.train.optim import trainable_mask, trainable_patterns_for_cfg

    mask = trainable_mask(tp.params, trainable_patterns_for_cfg(tp.cfg),
                          freeze_all=tp.cfg.freeze_all)
    sd = jax_params_to_state_dict(_broadcast(mask, tp.params))
    params = dict(tp.port.named_parameters(remove_duplicate=False))
    return {k for k, v in sd.items() if k in params and bool(v.all())}


def port_trainable(model):
    return {n for n, p in model.named_parameters(remove_duplicate=False) if p.requires_grad}


def trainable_model(tp):
    model = build_model(port_config(tp.cfg), device="cpu", dtype="float32")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(model.cfg),
                         freeze_all=model.cfg.freeze_all)
    return model


@pytest.mark.parametrize("preset", PRESETS)
def test_trainable_set_matches_jax(preset):
    tp = TinyPair(seed=0, **preset_overrides(preset))
    model = trainable_model(tp)
    got = port_trainable(model)
    assert got == jax_trainable(tp)
    unique = {n for n, p in model.named_parameters() if p.requires_grad}
    assert len(unique) == N_TRAINABLE[preset]
    if preset == "finetune":
        assert got == set(dict(model.named_parameters(remove_duplicate=False)))
    if preset == "berttune":
        assert {n.split(".")[0] for n in unique} == {"bert", "feat_map"}


# the JAX step's losses, gradients and matcher assignments, per architecture
_JAX_STEPS = {}


def jax_step(tp, batch):
    """(losses, gradients of every parameter, assignments) of JAX's
    `compute_losses` in train mode, its matcher recorded as it runs."""
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train.step import compute_losses

    key = architecture(tp.cfg)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    recorded = []
    orig = jcrit.match_batch

    def recording(*a, **k):
        out = orig(*a, **k)
        recorded.append(out)
        return out

    def loss_fn(p):
        recorded.clear()
        total, losses = compute_losses(tp.jmodel, tp.variables(p), batch, train=True)
        return total, (losses, list(recorded))

    jcrit.match_batch = recording
    try:
        (_, (losses, assignments)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tp.params)
    finally:
        jcrit.match_batch = orig
    _JAX_STEPS[key] = (losses, grads, [np.asarray(a) for a in assignments])
    return _JAX_STEPS[key]


@pytest.fixture(scope="module", params=PRESETS)
def stepped(request):
    """A preset's tiny pair at the weights of seed 1, the batch, the port's
    model after one pinned `compute_losses` + backward, its losses, and
    JAX's losses and gradients."""
    from tests.test_train_step import make_batch

    tp = TinyPair(seed=1, **preset_overrides(request.param))
    batch = make_batch()
    want_losses, want_grads, assignments = jax_step(tp, batch)
    model = trainable_model(tp)
    order = iter(assignments)
    orig = pcrit.match_batch
    pcrit.match_batch = pinned_matcher(order)
    try:
        total, losses = pstep.compute_losses(model, {k: _t(v).clone()
                                                     for k, v in batch.items()})
    finally:
        pcrit.match_batch = orig
    assert next(order, None) is None  # every head matched once, in JAX's order
    if total.requires_grad:
        total.backward()
    return request.param, tp, batch, model, losses, want_losses, want_grads


def test_train_step_losses_match_jax(stepped):
    """The loss dict (CAT's `loss_adapter` weighted by loss_adapter_weight,
    no other adapter loss in these presets) at 1e-4 of each loss."""
    preset, _, _, _, losses, want, _ = stepped
    assert sorted(losses) == sorted(want)
    assert {k for k in losses if "adapter" in k} == (
        {"loss_adapter"} if preset == "catgroundingdino" else set())
    err = {k: abs(losses[k].item() - float(v)) / max(abs(float(v)), 1e-30)
           for k, v in want.items()}
    assert max(err.values()) <= STEP_TOL, err
    assert np.isfinite(losses["total_loss"].item())


def test_train_step_gradients_match_jax(stepped):
    """The gradient of every trainable parameter at 1e-4 of its scale (for
    finetune every parameter, Swin's and BERT's included); frozen
    parameters get none, and a trainable one the loss does not reach (CAT's
    `w_noise` without noisy gating) none where JAX's is 0. BERT's key
    biases, whose gradient is 0 in exact arithmetic, are held at 1e-4 of
    the key weight gradient's scale, and the fusion layers' `v_proj` bias,
    a near-cancelling sum, at FUSION_V_BIAS_TOL of its own. A preset with
    nothing to train (prompttune) has a loss without a graph."""
    preset, _, _, model, losses, _, want_grads = stepped
    want = {n: v.numpy() for n, v in jax_params_to_state_dict(want_grads).items()}
    err, tol, zero_in_exact = {}, {}, set()
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, n
            continue
        if p.grad is None:
            assert not want[n].any(), n
            err[n] = 0.0
            continue
        scale = np.abs(want[n]).max()
        if n.endswith(ZERO_IN_EXACT):
            scale = np.abs(want[n[:-len("bias")] + "weight"]).max()
            zero_in_exact.add(n)
        if n.startswith(FUSION_V_BIAS[0]) and n.endswith(FUSION_V_BIAS[1]):
            tol[n] = FUSION_V_BIAS_TOL
        err[n] = np.abs(p.grad.numpy() - want[n]).max() / max(scale, 1e-30)
    assert len(err) == N_TRAINABLE[preset]
    if preset in ("finetune", "berttune"):
        assert zero_in_exact == {f"bert.encoder.layer.{i}.attention.self.key.bias"
                                 for i in (0, 1)}
    if preset == "finetune":
        assert len(tol) == 2  # both fusion layers
    assert (preset == "prompttune") != losses["total_loss"].requires_grad
    bad = {n: e for n, e in err.items() if e > tol.get(n, STEP_TOL)}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    if preset == "finetune":
        for part in ("backbone.0.patch_embed.proj.weight",
                     "bert.embeddings.word_embeddings.weight"):
            assert np.abs(model.get_parameter(part).grad.numpy()).max() > 0, part


def test_prompttune_step_changes_nothing():
    """`prompttune` has no trainable parameter (JAX keeps its prompts outside
    the parameters and never optimises them): `train_step` computes the
    losses, reports a gradient norm of 0, and leaves every weight and
    buffer bitwise as it was, with an EMA too."""
    from tests.test_train_step import make_batch

    tp = TinyPair(seed=1, **preset_overrides("prompttune"))
    model = trainable_model(tp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = poptim.Optimizer(model, ema_decay=0.9)
    batch = {k: _t(v).clone() for k, v in make_batch().items()}
    for _ in range(2):
        metrics = pstep.train_step(model, opt, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["total_loss"].item()) and metrics["grad_norm"].item() == 0.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    state = opt.state_dict()
    assert state["adamw"] is None and state["ema"] == {}
    opt.load_state_dict(state)


def test_finetune_trains_after_serving():
    """A model that served a request (under `torch.inference_mode`) can then
    train Swin: the tables Swin caches on its first call are not inference
    tensors, which the backward could not save."""
    from tests.test_train_step import make_batch

    tp = TinyPair(seed=1, **preset_overrides("finetune"))
    model = trainable_model(tp)
    batch = {k: _t(v).clone() for k, v in make_batch().items()}
    with torch.inference_mode():
        model(batch["pixels"], batch["mask"], {k: batch[k] for k in pstep.TEXT_KEYS})
    metrics = pstep.train_step(model, poptim.Optimizer(model), batch)
    assert np.isfinite(metrics["total_loss"].item()) and metrics["grad_norm"].item() > 0


def test_adamw_steps_a_leaf_without_gradient_as_optax():
    """A trainable leaf that the backward leaves without a gradient steps
    as optax's AdamW steps the zero gradient that `jax.grad` gives it: its
    moments decay and the weight decay shrinks it. Three updates of a tree
    with a leaf that has a gradient only in the first (CAT's `w_noise` once
    the gating is no longer noisy) and one that never has one, against the
    JAX package's optax chain, clip and warmup included."""
    import jax.numpy as jnp
    import optax
    from tests.test_torch_train import OPT_TOL, _Tree
    from ziragroundingdino_tpu.config import OptimizerConfig as JOpt
    from ziragroundingdino_tpu.config import ScheduleConfig as JSched
    from ziragroundingdino_tpu.train.optim import build_optimizer, trainable_mask

    rng = np.random.RandomState(2)
    params = {"adapter_w": rng.randn(4, 3).astype(np.float32),
              "adapter_noise": rng.randn(3).astype(np.float32),
              "adapter_gate": rng.randn(3).astype(np.float32)}
    grads = [{k: (0.05 * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    for i, g in enumerate(grads):
        g["adapter_gate"] = None
        if i:
            g["adapter_noise"] = None
    opt_kw = dict(lr=1e-2, weight_decay=0.5, grad_clip=0.1)
    sched_kw = dict(max_iter=10, warmup_iter=2)

    tx = build_optimizer(JOpt(**opt_kw), JSched(**sched_kw), params,
                         trainable=trainable_mask(params, ("adapter",)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        jg = {k: jnp.zeros_like(jp[k]) if v is None else jnp.asarray(v) for k, v in g.items()}
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)

    model = _Tree(params)
    poptim.set_trainable(model, ("adapter",))
    opt = poptim.Optimizer(model, poptim.OptimizerConfig(**opt_kw),
                           poptim.ScheduleConfig(**sched_kw))
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = None if g[k] is None else _t(g[k]).clone()
        opt.step()
    for k, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jp[k]), rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=k)
        # the decay alone moves the leaf by far more than the tolerance
        assert np.abs(got - params[k]).max() > 1e3 * OPT_TOL, k
