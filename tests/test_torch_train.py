"""The port's train step against the JAX package's, f32 on the CPU.

In order: the box ops, the cost matrix and the assignment, the set
criterion given one assignment, the schedules and one AdamW + clip +
lr-factor update against optax, then the whole step at `tiny_config` with
`TinyPair`'s weights and `test_train_step.make_batch`'s targets: every loss
of `compute_losses` and the gradient of every trainable parameter against
JAX's `jax.grad` of `compute_losses`, with both matchers pinned to the
assignments JAX's own matcher makes on JAX's outputs (near-ties flip at
random init, so the port's matcher is held against JAX's apart), at the
weights of seed 1 and of seed 0, where a ReLU kink lies within f32 rounding
(`seed0_setup`). Then two
port steps (frozen weights bit-identical, adapters moved, the EMA lagging)
and dropout from the step's generator.
"""

import dataclasses
from collections.abc import Mapping

import numpy as np
import pytest
import torch

from ziragroundingdino_torch.ops import box_ops as pbox
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import matcher as pmatch
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.weights import jax_params_to_state_dict

TOL = 1e-5  # box ops, costs and criterion: f32 elementwise arithmetic
STEP_TOL = 1e-4  # whole step, times each quantity's own largest magnitude
OPT_TOL = 1e-6  # optimizer update and schedules against optax


def _boxes(rng, shape):
    """Random cxcywh boxes inside [0, 1]."""
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_box_ops_match_jax():
    from ziragroundingdino_tpu.ops import box_ops as jbox

    rng = np.random.RandomState(0)
    a, b = _boxes(rng, (7,)), _boxes(rng, (5,))
    xa, xb = jbox.box_cxcywh_to_xyxy(a), jbox.box_cxcywh_to_xyxy(b)
    np.testing.assert_allclose(pbox.box_cxcywh_to_xyxy(_t(a)).numpy(), xa, atol=TOL)
    np.testing.assert_allclose(pbox.box_xyxy_to_cxcywh(_t(xa)).numpy(),
                               jbox.box_xyxy_to_cxcywh(xa), atol=TOL)
    np.testing.assert_allclose(pbox.generalized_box_iou_matrix(_t(xa), _t(xb)).numpy(),
                               jbox.generalized_box_iou_matrix(xa, xb), atol=TOL)
    np.testing.assert_allclose(
        pbox.generalized_box_iou_elementwise(_t(xa[:5]), _t(xb)).numpy(),
        jbox.generalized_box_iou_elementwise(xa[:5], xb), atol=TOL)
    x = rng.uniform(-0.1, 1.1, (20,)).astype(np.float32)
    np.testing.assert_allclose(pbox.inverse_sigmoid(_t(x)).numpy(), jbox.inverse_sigmoid(x),
                               atol=TOL)


def _predictions(seed=0, b=2, q=12, c=4, n=5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, q, c).astype(np.float32)
    boxes = _boxes(rng, (b, q))
    labels = rng.randint(0, c, (b, n)).astype(np.int32)
    tgt = _boxes(rng, (b, n))
    valid = np.zeros((b, n), bool)
    valid[0, :3] = True
    valid[1, :1] = True
    return logits, boxes, labels, tgt, valid


def test_cost_matrix_and_assignment_match_jax():
    """The cost matrix at 1e-5; both matchers against JAX's: the port's
    `impl="scipy"` assignment equals JAX's `impl="scipy"`, its default
    `impl="lsap"` equals JAX's default `impl="jax"` (`lsap_jax`). On seeded
    costs with invalid (BIG) columns, the scipy path has `lsap_jax`'s total
    cost and the lsap path its assignment."""
    import jax
    from ziragroundingdino_tpu.train import matcher as jmatch

    pred = _predictions()
    want = jax.vmap(jmatch.pairwise_cost_matrix)(*pred)
    got = pmatch.pairwise_cost_matrix(*map(_t, pred))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(pmatch.match_batch(*map(_t, pred), impl="scipy").numpy(),
                                  jmatch.match_batch(*pred, impl="scipy"))
    np.testing.assert_array_equal(pmatch.match_batch(*map(_t, pred)).numpy(),
                                  jmatch.match_batch(*pred, impl="jax"))

    rng = np.random.RandomState(3)
    cost = rng.rand(3, 9, 6).astype(np.float32)
    cost[:, :, 4:] = pmatch.BIG  # two invalid target columns per image
    ours = pmatch.assign(_t(cost), impl="scipy").numpy()
    theirs = np.asarray(jax.vmap(jmatch.lsap_jax)(cost))
    np.testing.assert_array_equal(pmatch.assign(_t(cost), impl="lsap").numpy(), theirs)
    for i in range(3):
        assert len(set(ours[i])) == 6
        np.testing.assert_allclose(cost[i, ours[i], range(6)].sum(),
                                   cost[i, theirs[i], range(6)].sum(), rtol=1e-6)


def test_criterion_matches_jax_given_one_assignment(monkeypatch):
    """Focal, L1 and GIoU losses of the last layer, an aux layer and the
    encoder head, with both criteria given the same assignments."""
    from ziragroundingdino_tpu.train import criterion as jcrit

    logits, boxes, labels, tgt, valid = _predictions(seed=4)
    rng = np.random.RandomState(5)
    assignments = [np.stack([rng.permutation(12)[:5] for _ in range(2)]) for _ in range(3)]
    outs = [(logits + i, np.clip(boxes + 0.01 * i, 0.0, 1.0)) for i in range(3)]

    def pinned(module):
        order = iter(assignments)
        monkeypatch.setattr(module, "match_batch", lambda *a, **k: next(order))

    def nest(to):
        (l0, b0), (l1, b1), (l2, b2) = [(to(x), to(y)) for x, y in outs]
        return {"pred_logits": l0, "pred_boxes": b0,
                "aux_outputs": [{"pred_logits": l1, "pred_boxes": b1}],
                "interm_outputs": {"pred_logits": l2, "pred_boxes": b2}}

    from tests.torch_common import pinned_matcher

    pinned(jcrit)
    want = jcrit.set_criterion(nest(np.asarray), labels, tgt, valid)
    monkeypatch.setattr(pcrit, "match_batch", pinned_matcher(iter(assignments)))
    got = pcrit.set_criterion(nest(_t), *map(_t, (labels, tgt, valid)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=TOL, err_msg=k)
    np.testing.assert_allclose(pcrit.weighted_total(got).item(),
                               float(jcrit.weighted_total(want)), rtol=TOL)


@pytest.mark.parametrize("name", ["multistep", "cosine", "linear", "constant", "exponential"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(name, warmup):
    from ziragroundingdino_tpu.config import ScheduleConfig as JSched
    from ziragroundingdino_tpu.train.optim import make_schedule

    kw = dict(name=name, max_iter=18, warmup_iter=warmup, gamma=0.5)
    want = make_schedule(JSched(**kw))
    got = poptim.make_schedule(poptim.ScheduleConfig(**kw))
    for step in range(24):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=OPT_TOL, atol=OPT_TOL,
                                   err_msg=f"step {step}")


class _Tree(torch.nn.Module):
    """Parameters named as a small JAX tree's leaves."""

    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(_t(v).clone()))


def test_adamw_clip_and_lr_factors_match_optax():
    """Three updates of a small tree with a frozen leaf, an lr factor and a
    warmup schedule against the JAX package's optax chain; then a huge
    gradient on the frozen leaf leaves the trainable update as it was
    (`test_train_step.py::test_clip_norm_ignores_frozen_grads`)."""
    import jax.numpy as jnp
    import optax
    from ziragroundingdino_tpu.config import OptimizerConfig as JOpt
    from ziragroundingdino_tpu.config import ScheduleConfig as JSched
    from ziragroundingdino_tpu.train.optim import build_optimizer, trainable_mask

    rng = np.random.RandomState(0)
    params = {"base_w": rng.randn(4).astype(np.float32),
              "adapter_w": rng.randn(4, 3).astype(np.float32),
              "freeze_adapter_b": rng.randn(3).astype(np.float32)}
    grads = [{k: (s * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (0.01, 1.0, 0.05)]  # the second is clipped
    opt_kw = dict(lr=1e-2, grad_clip=0.1, lr_factors=(("freeze", 0.2),))
    sched_kw = dict(max_iter=10, warmup_iter=2)

    tx = build_optimizer(JOpt(**opt_kw), JSched(**sched_kw), params,
                         trainable=trainable_mask(params, ("adapter",)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    model = _Tree(params)
    poptim.set_trainable(model, ("adapter",))
    opt = poptim.Optimizer(model, poptim.OptimizerConfig(**opt_kw),
                           poptim.ScheduleConfig(**sched_kw))
    norms = []
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = _t(g[k]).clone() if p.requires_grad else None
        norms.append(opt.step().item())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=OPT_TOL,
                                   atol=OPT_TOL, err_msg=k)
    np.testing.assert_allclose(norms[1], np.sqrt(sum((grads[1][k] ** 2).sum()
                                                     for k in ("adapter_w", "freeze_adapter_b"))),
                               rtol=OPT_TOL)

    updates = []
    for base_grad in (0.0, 1e6):
        m = _Tree(params)
        poptim.set_trainable(m, ("adapter",))
        o = poptim.Optimizer(m, poptim.OptimizerConfig(**opt_kw), poptim.ScheduleConfig())
        m.base_w.grad = torch.full((4,), base_grad)
        m.adapter_w.grad = torch.full((4, 3), 0.5)
        m.freeze_adapter_b.grad = torch.full((3,), 0.5)
        o.step()
        assert torch.equal(m.base_w.detach(), _t(params["base_w"]))
        updates.append(m.adapter_w.detach() - _t(params["adapter_w"]))
    torch.testing.assert_close(updates[0], updates[1], rtol=OPT_TOL, atol=0)


# JAX's jitted train-mode forward on `make_batch()` by config
_FORWARDS = {}


def _jax_step(seed, **overrides):
    """The tiny pair of weights `seed` (its config `tiny_config(**overrides)`),
    the batch, JAX's train-mode assignments (JAX's matcher on JAX's outputs,
    in set_criterion's order) and JAX's losses and gradients with its
    matcher pinned to them."""
    import jax
    import jax.numpy as jnp
    from tests.test_train_step import make_batch
    from tests.torch_common import TinyPair
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train import matcher as jmatch
    from ziragroundingdino_tpu.train.step import class_logits_from_tokens, compute_losses

    tp = TinyPair(seed=seed, **overrides)
    batch = make_batch()
    text = {k: batch[k] for k in pstep.TEXT_KEYS}
    key = repr(tp.cfg)
    if key not in _FORWARDS:  # the weights of every seed through one trace
        _FORWARDS[key] = jax.jit(lambda p, jmodel=tp.jmodel: jmodel.apply(
            {"params": p}, batch["pixels"], batch["mask"], text, train=True))
    out = _FORWARDS[key](tp.params)
    c2t = batch["cate_to_token_mask"]
    heads = [out] + list(out["aux_outputs"]) + [out["interm_outputs"]]
    # JAX's own matcher (`impl="jax"`, what its train step runs; under jit
    # the scipy callback gets a non-finite focal cost for the saturated
    # encoder-head scores)
    assignments = [np.asarray(jmatch.match_batch(
        class_logits_from_tokens(o["pred_logits"], c2t), o["pred_boxes"], batch["gt_labels"],
        batch["gt_boxes"], batch["gt_valid"])) for o in heads]

    order = iter(assignments)
    orig = jcrit.match_batch
    jcrit.match_batch = lambda *a, **k: jnp.asarray(next(order))
    try:
        (_, losses), grads = jax.jit(jax.value_and_grad(
            lambda p: compute_losses(tp.jmodel, {"params": p}, batch, train=True),
            has_aux=True))(tp.params)
    finally:
        jcrit.match_batch = orig
    return tp, batch, assignments, losses, grads


@pytest.fixture(scope="module")
def step_setup():
    """`_jax_step` at the weights of seed 1, which the step tests share."""
    return _jax_step(1)


@pytest.fixture(scope="module")
def seed0_setup():
    """`_jax_step` at the shared tiny fixture's weights (seed 0). There the
    port's f32 rounding leaves one ReLU input of the first encoder layer's
    FFN at -8.3e-7, on the other side of the kink from JAX's, so that the
    conv adapters of levels 0-2 get gradients that differ from JAX's by up
    to 2e-3 of their scale; with the port's weights moved by one ulp the
    input changes sign and every gradient meets JAX's at 1e-4."""
    return _jax_step(0)


def _port_model(tp, cfg=None):
    from ziragroundingdino_torch.models import build_model
    from tests.torch_common import port_config

    model = build_model(cfg or port_config(tp.cfg), device="cpu", dtype="float32")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    poptim.set_trainable(model, poptim.ZIRA_TRAINABLE_PATTERNS)
    return model


def _torch_batch(batch):
    return {k: _t(v).clone() for k, v in batch.items()}


def _pin_port_matcher(monkeypatch, assignments):
    from tests.torch_common import pinned_matcher

    monkeypatch.setattr(pcrit, "match_batch", pinned_matcher(iter(assignments)))


def test_trainable_set_matches_jax(step_setup):
    from ziragroundingdino_tpu.train.optim import trainable_mask

    tp = step_setup[0]
    mask = trainable_mask(tp.params, ("adapter",))
    flags = jax_params_to_state_dict(
        {k: v for k, v in _broadcast(mask, tp.params).items()})
    want = {k for k, v in flags.items() if bool(v.all())}
    model = _port_model(tp)
    got = {n for n, p in model.named_parameters() if p.requires_grad}
    assert got == want and len(got) == 5 * 5  # 1 linear + 4 conv adapters, 5 leaves each
    assert got == {n for n, t in poptim.trainable_mask(
        model, poptim.ZIRA_TRAINABLE_PATTERNS).items() if t}


def _broadcast(mask, params):
    """A bool tree as arrays of each parameter's shape (the weight bridge
    transposes leaves, so they need their shapes)."""
    if isinstance(mask, Mapping):
        return {k: _broadcast(mask[k], params[k]) for k in mask}
    return np.full(np.shape(params), bool(mask))


def _nudge_by_one_ulp(model, seed):
    """Every parameter times (1 +- 2**-24), the sign seeded: the weights
    moved within their f32 rounding."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g).to(p.dtype) * 2 - 1
            p.mul_(1 + sign * 2.0 ** -24)


def _port_step(setup, monkeypatch, nudge=None):
    """The port's losses and trainable gradients at the setup's weights, or
    at those moved by `_nudge_by_one_ulp(model, nudge)`, the matcher pinned
    to JAX's assignments."""
    tp, batch, assignments, _, _ = setup
    model = _port_model(tp)
    if nudge is not None:
        _nudge_by_one_ulp(model, nudge)
    _pin_port_matcher(monkeypatch, assignments)
    total, losses = pstep.compute_losses(model, _torch_batch(batch))
    total.backward()
    grads = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            grads[n] = p.grad.numpy()
        else:
            assert p.grad is None, n
    assert len(grads) == 25
    return {k: v.item() for k, v in losses.items()}, grads


def _step_errors(setup, monkeypatch, nudge=None):
    """`_port_step` against JAX: {loss name: relative error}, {parameter
    name: max |difference| / max |JAX's gradient|}, the port's gradients
    and JAX's."""
    _, _, _, want_losses, want_grads = setup
    losses, grads = _port_step(setup, monkeypatch, nudge)
    assert sorted(losses) == sorted(want_losses)
    loss_err = {k: abs(losses[k] - float(v)) / max(abs(float(v)), 1e-30)
                for k, v in want_losses.items()}
    want = {n: v.numpy() for n, v in jax_params_to_state_dict(want_grads).items()}
    grad_err = {n: np.abs(g - want[n]).max() / max(np.abs(want[n]).max(), 1e-30)
                for n, g in grads.items()}
    return loss_err, grad_err, grads, want


@pytest.mark.parametrize("weights", ["seed1", "seed0_nudged"])
def test_train_step_matches_jax(weights, request, monkeypatch):
    """Every entry of `compute_losses`' loss dict, and the gradient of every
    trainable parameter, against JAX at 1e-4 of each one's magnitude (the
    losses relative, each gradient tensor against its largest entry: f32
    rounding through the whole model, forward and backward). At seed 0 the
    port's weights are first moved by one ulp (`seed0_setup`)."""
    if weights == "seed1":
        setup, nudge = request.getfixturevalue("step_setup"), None
    else:
        setup, nudge = request.getfixturevalue("seed0_setup"), 1
    loss_err, grad_err, _, _ = _step_errors(setup, monkeypatch, nudge)
    assert max(loss_err.values()) <= STEP_TOL, loss_err
    assert max(grad_err.values()) <= STEP_TOL, grad_err


# seed 0 unmoved: the conv adapters behind the ReLU kink (`seed0_setup`),
# 2.1e-3 of their scale measured; every other gradient at STEP_TOL
SEED0_KINK_LEAVES = tuple(f"input_proj_conv_adapter.{lvl}." for lvl in range(3))
SEED0_KINK_TOL = 5e-3


def test_train_step_at_seed0_weights(seed0_setup, monkeypatch):
    """The port at seed 0 as it is: the losses, the linear adapter and the
    last level's conv adapter at STEP_TOL; the conv adapters of levels 0-2
    at SEED0_KINK_TOL; those move by as much as they differ from JAX when
    the weights move by one ulp, and a ReLU input within 1e-5 of 0 changes
    sign with them, so the gap is the kink's, not a fault of the port (the
    moved weights meet JAX at STEP_TOL, above). Prints the readings."""
    relu_inputs = []
    relu = torch.relu  # `F.relu` calls it too
    monkeypatch.setattr(torch, "relu", lambda x: relu_inputs.append(x.detach()) or relu(x))
    loss_err, grad_err, grads, want = _step_errors(seed0_setup, monkeypatch)
    unmoved, relu_inputs[:] = list(relu_inputs), []
    _, nudged = _port_step(seed0_setup, monkeypatch, nudge=1)
    monkeypatch.setattr(torch, "relu", relu)

    assert max(loss_err.values()) <= STEP_TOL, loss_err
    kinked = {n: e for n, e in grad_err.items() if n.startswith(SEED0_KINK_LEAVES)}
    smooth = {n: e for n, e in grad_err.items() if n not in kinked}
    assert len(kinked) == 15 and max(smooth.values()) <= STEP_TOL, smooth
    assert max(kinked.values()) <= SEED0_KINK_TOL, kinked
    moved = {n: np.abs(grads[n] - nudged[n]).max() / np.abs(want[n]).max() for n in kinked}
    flips = [(i, tuple(a.shape), a[(a > 0) != (b > 0)].tolist())
             for i, (a, b) in enumerate(zip(unmoved, relu_inputs)) if ((a > 0) != (b > 0)).any()]
    print(f"seed 0: ReLU inputs that change sign under one ulp (call, shape, values): {flips}")
    for n in sorted(kinked):
        print(f"seed 0: {n}: port vs JAX {grad_err[n]:.3e}, moved by one ulp {moved[n]:.3e} "
              f"of its scale")
    assert flips and all(abs(v) < 1e-5 for _, _, vals in flips for v in vals), flips
    for n in kinked:
        np.testing.assert_allclose(moved[n], grad_err[n], rtol=0.1, atol=STEP_TOL, err_msg=n)


def test_two_port_steps_move_adapters_only(step_setup, monkeypatch):
    """After two steps the frozen tensors are bit-identical, every ZiRa
    branch moved, and the EMA (decay 0.5) lags the weights by half a step."""
    tp, batch, assignments, _, _ = step_setup
    model = _port_model(tp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = poptim.Optimizer(model, poptim.OptimizerConfig(lr=1e-2),
                           poptim.ScheduleConfig(max_iter=10), ema_decay=0.5)
    ema_want = {n: p.detach().clone() for n, p in opt.params.items()}
    for _ in range(2):
        _pin_port_matcher(monkeypatch, assignments)
        metrics = pstep.train_step(model, opt, _torch_batch(batch))
        assert torch.isfinite(metrics["total_loss"]) and metrics["grad_norm"] > 0
        for n, p in opt.params.items():
            ema_want[n] = 0.5 * ema_want[n] + 0.5 * p.detach()
    trainable = set(opt.params)
    moved = 0
    for k, v in model.state_dict().items():
        if k in trainable:
            moved += not torch.equal(v, before[k])
        else:
            assert torch.equal(v, before[k]), k
    assert moved == len(trainable)
    for n in trainable:
        torch.testing.assert_close(opt.ema[n], ema_want[n], rtol=1e-6, atol=1e-9)
        assert not torch.equal(opt.ema[n], opt.params[n].detach())


def test_dropout_follows_the_generator(step_setup, monkeypatch):
    """With every dropout rate above 0, one generator seed gives one loss
    and two seeds give two; no generator is the deterministic forward."""
    tp, batch, assignments, want_losses, _ = step_setup
    from tests.torch_common import port_config

    cfg = port_config(tp.cfg)
    cfg = dataclasses.replace(
        cfg, dropout=0.1, text_dropout=0.1, fusion_dropout=0.1, fusion_droppath=0.1,
        swin_config=dataclasses.replace(cfg.swin_config, drop_path_rate=0.2),
        bert_config=dataclasses.replace(cfg.bert_config, hidden_dropout=0.1,
                                        attention_dropout=0.1))
    model = _port_model(tp, cfg)
    tb = _torch_batch(batch)

    def loss(seed):
        _pin_port_matcher(monkeypatch, assignments)
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return pstep.compute_losses(model, tb, g)[0].item()

    a, b, c = loss(1), loss(1), loss(2)
    assert a == b and a != c
    np.testing.assert_allclose(loss(None), float(want_losses["total_loss"]), rtol=STEP_TOL)


def test_decoder_anchors_are_detached(step_setup):
    """The decoder starts from detached anchors (`transformer.py:555` of the
    JAX package): its first references carry no gradient, the two-stage
    heads' boxes and features do. (At the tiny parity step every selected
    query sits on a padded position with a saturated anchor, so the
    gradient comparison alone cannot see a missing detach.)"""
    tp, batch, _, _, _ = step_setup
    model = _port_model(tp)
    captured = {}
    hook = model.transformer.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("tr", out))
    try:
        tb = _torch_batch(batch)
        model(tb["pixels"], tb["mask"], {k: tb[k] for k in pstep.TEXT_KEYS}, train=True)
    finally:
        hook.remove()
    tr = captured["tr"]
    assert not tr["references"][0].requires_grad
    assert tr["references"][1].requires_grad
    assert tr["ref_enc"].requires_grad and tr["hs_enc"].requires_grad
