"""The port's loss library, `box_ops` helpers and the replay phase's image
hooks against the JAX package's, f32 on the CPU:

* every loss of `train/losses.py` at 1e-6, with each `reduction`, a
  `weight`, an `avg_factor`, and the focal loss at logits of +-30;
* `box_iou_pairwise_matrix`, `box_iou_elementwise` and `masks_to_boxes`
  (degenerate boxes, an empty mask) at 1e-6;
* two `run_replay_phase` iterations with `image_batch_fn` / `image_loss_fn`
  on the tiny ZiRa pair and on the repconv preset, where only the image
  loss has a gradient: every tensor after the merge at 1e-5; and an
  iteration whose batch is None, bitwise the text replay's own (the JAX
  text replay is held in `tests/test_torch_lifecycle.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.test_torch_presets import preset_overrides
from tests.torch_common import TinyPair, assert_close, port_config, torch_text
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.ops import box_ops as pbox
from ziragroundingdino_torch.train import incremental as pinc
from ziragroundingdino_torch.train import losses as pl
from ziragroundingdino_torch.weights import jax_params_to_state_dict
from ziragroundingdino_tpu.ops import box_ops as jbox
from ziragroundingdino_tpu.train import incremental as jinc
from ziragroundingdino_tpu.train import losses as jl

LOSS_TOL = 1e-6
TEXT_TOL = 1e-5  # the replay phase, as `tests/test_torch_lifecycle.py` holds the text replay
CLASSES = ["cat", "dog", "zebra"]


def _boxes(rng, n):
    """cxcywh boxes in the unit square; the last one degenerate (zero width)."""
    b = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))], 1)
    b[-1, 2] = 0.0
    return b.astype(np.float32)


def _inputs(name, rng):
    """(args, kwargs) of loss `name` as numpy arrays."""
    if name == "sigmoid_focal_loss":
        pred = (rng.randn(6, 5) * 4).astype(np.float32)
        pred[0, :4] = (30.0, -30.0, 30.0, -30.0)  # saturated logits, both targets
        tgt = (rng.rand(6, 5) > 0.7).astype(np.float32)
        tgt[0, :4] = (1.0, 1.0, 0.0, 0.0)
        return (pred, tgt), {"alpha": 0.25, "gamma": 2.0}, (6, 5)
    if name in ("l1_loss", "smooth_l1_loss"):
        return (rng.randn(7, 4).astype(np.float32), rng.randn(7, 4).astype(np.float32)), \
            ({"beta": 0.5} if name == "smooth_l1_loss" else {}), (7, 4)
    if name == "giou_loss":
        return (_boxes(rng, 6), _boxes(rng, 6)), {}, (6,)
    if name == "cross_entropy_loss":
        return (rng.randn(5, 9).astype(np.float32), rng.randint(0, 9, 5)), {}, (5,)
    assert name == "dice_loss"
    return (rng.randn(4, 30).astype(np.float32), (rng.rand(4, 30) > 0.5).astype(np.float32)), \
        {"eps": 1e-3}, (4,)


LOSSES = ("sigmoid_focal_loss", "l1_loss", "smooth_l1_loss", "giou_loss", "cross_entropy_loss",
          "dice_loss")
REDUCTIONS = [("none", False, None), ("sum", False, None), ("mean", False, None),
              ("mean", True, None), ("mean", True, 3.5), ("sum", True, None),
              ("mean", False, 0.0)]


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("reduction,weighted,avg_factor", REDUCTIONS)
def test_loss_matches_jax(name, reduction, weighted, avg_factor):
    rng = np.random.RandomState(LOSSES.index(name))
    args, kw, shape = _inputs(name, rng)
    if weighted:
        kw["weight"] = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    kw = dict(kw, reduction=reduction, avg_factor=avg_factor)
    want = getattr(jl, name)(*(jnp.asarray(a) for a in args),
                             **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                for k, v in kw.items()})
    got = getattr(pl, name)(*(torch.from_numpy(np.asarray(a)) for a in args),
                            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()})
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert_close(got / scale, want / scale, LOSS_TOL, what=name)


def test_focal_loss_finite_and_right_at_saturated_logits():
    """At |logit| = 30 the f32 sigmoid is 0 or 1: a right guess costs 0, a
    wrong one its cross-entropy of 30 times alpha (or 1 - alpha)."""
    pred = torch.tensor([30.0, -30.0, 30.0, -30.0])
    tgt = torch.tensor([1.0, 0.0, 0.0, 1.0])
    got = pl.sigmoid_focal_loss(pred, tgt, reduction="none")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), [0.0, 0.0, 0.75 * 30.0, 0.25 * 30.0], rtol=1e-6,
                               atol=1e-12)


def test_box_iou_helpers_match_jax():
    rng = np.random.RandomState(5)
    a = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 7))))
    b = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 5))))
    b[0] = a[0]  # an identical pair
    b[1] = (0.9, 0.9, 0.8, 0.8)  # inverted corners
    for fn, x, y in (("box_iou_pairwise_matrix", a, b), ("box_iou_elementwise", a[:5], b)):
        want = getattr(jbox, fn)(jnp.asarray(x), jnp.asarray(y))
        got = getattr(pbox, fn)(torch.from_numpy(x), torch.from_numpy(y))
        assert len(got) == len(want) == 2
        for g, w, what in zip(got, want, ("iou", "union")):
            assert g.shape == w.shape
            assert_close(g, w, LOSS_TOL, what=f"{fn} {what}")
    # batched leading dims
    want = jbox.box_iou_pairwise_matrix(jnp.asarray(a[None]), jnp.asarray(b[None]))[0]
    assert_close(pbox.box_iou_pairwise_matrix(torch.from_numpy(a[None]),
                                              torch.from_numpy(b[None]))[0], want, LOSS_TOL)


@pytest.mark.parametrize("dtype", [bool, np.uint8, np.float32])
def test_masks_to_boxes_matches_jax(dtype):
    rng = np.random.RandomState(2)
    masks = rng.rand(4, 9, 13) > 0.8
    masks[1] = False  # empty: (1e8, 1e8, 0, 0)
    masks[2] = False
    masks[2, 4, 7] = True  # one pixel
    masks = masks.astype(dtype)
    want = np.asarray(jbox.masks_to_boxes(jnp.asarray(masks)))
    got = pbox.masks_to_boxes(torch.from_numpy(masks))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[1], [1e8, 1e8, 0, 0])
    np.testing.assert_array_equal(want[2], [7, 4, 7, 4])


def _memory(model, tok):
    """A prompt memory of CLASSES away from the current features."""
    pm = pinc.add_cls_prompt({}, model, tok, CLASSES, max_text_len=32)
    rng = np.random.RandomState(3)
    return {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32) for k, v in pm.items()}


def _targets(tp):
    """Seeded token targets [B, Q, T] and boxes [B, Q, 4] of the pair's batch."""
    rng = np.random.RandomState(11)
    b, q, t = len(tp.pixels), tp.cfg.num_queries, tp.tb.input_ids.shape[1]
    tokens = (rng.rand(b, q, t) > 0.8).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (b, q, 2)),
                            rng.uniform(0.1, 0.3, (b, q, 2))], -1).astype(np.float32)
    return tokens, boxes


def _jax_image_loss(tp, tokens, boxes):
    def loss(p, batch):
        out = tp.jmodel.apply(tp.variables(p), batch["pixels"], batch["mask"], batch["text"],
                              train=True)
        valid = batch["text"]["text_token_mask"][:, None, :]
        logits = jnp.where(valid, out["pred_logits"][..., :valid.shape[-1]], 0.0)
        return (jl.sigmoid_focal_loss(logits, tokens, weight=valid.astype(jnp.float32),
                                      avg_factor=4.0)
                + jl.l1_loss(out["pred_boxes"], boxes) + jl.giou_loss(out["pred_boxes"], boxes))
    return loss


def _port_image_loss(tokens, boxes):
    tokens, boxes = torch.from_numpy(tokens), torch.from_numpy(boxes)

    def loss(model, batch):
        out = model(batch["pixels"], batch["mask"], batch["text"], train=True)
        valid = batch["text"]["text_token_mask"][:, None, :]
        logits = torch.where(valid, out["pred_logits"][..., :valid.shape[-1]], 0.0)
        return (pl.sigmoid_focal_loss(logits, tokens, weight=valid.float(), avg_factor=4.0)
                + pl.l1_loss(out["pred_boxes"], boxes) + pl.giou_loss(out["pred_boxes"], boxes))
    return loss


def _batches(batch, n):
    """An `image_batch_fn` that gives `batch` on its first `n` calls and None after."""
    left = [batch] * n
    return lambda: left.pop() if left else None


# the tiny ZiRa pair, and the repconv preset, whose text replay reaches no
# trainable parameter
REPLAY_CASES = [{}, preset_overrides("repgroundingdino")]


@pytest.mark.parametrize("overrides", REPLAY_CASES, ids=["zira", "repconv"])
def test_replay_phase_with_image_hooks_matches_jax(overrides):
    """Two replay iterations with the image hooks, then the merge: every
    tensor as JAX's leaves it. One encoder and one decoder layer: JAX
    compiles a forward and backward of the whole model for each case."""
    tp = TinyPair(**overrides, enc_layers=1, dec_layers=1)
    tok = tiny_tokenizer()
    model = build_model(port_config(tp.cfg), device="cpu", dtype="float32")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    pm = _memory(model, tok)
    tokens, boxes = _targets(tp)

    jbatch = {"pixels": jnp.asarray(tp.pixels), "mask": jnp.asarray(tp.mask), "text": tp.text}
    jstate = jinc.IncrementalState(params=tp.params, prompt_memory=dict(pm),
                                   learned_classes=list(CLASSES))
    jstate = jinc.run_replay_phase(jstate, tp.cfg, tok, iters=2,
                                   image_batch_fn=_batches(jbatch, 2),
                                   image_loss_fn=_jax_image_loss(tp, tokens, boxes))

    pbatch = {"pixels": torch.from_numpy(tp.pixels), "mask": torch.from_numpy(tp.mask),
              "text": torch_text(tp.tb)}
    calls = []
    loss_fn = _port_image_loss(tokens, boxes)

    def counted(m, b):
        calls.append(b)
        return loss_fn(m, b)
    state = pinc.IncrementalState(params=pinc.snapshot(model), prompt_memory=dict(pm),
                                  learned_classes=list(CLASSES))
    state = pinc.run_replay_phase(state, model, tok, iters=2,
                                  image_batch_fn=_batches(pbatch, 2),
                                  image_loss_fn=counted)
    assert len(calls) == 2

    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert state.params.keys() == want.keys()
    for k in want:
        assert_close(state.params[k], want[k].numpy(), TEXT_TOL, what=f"after replay: {k}")
    before = tp.port.state_dict()
    moved = [k for k in want if "adapter" in k and not torch.equal(state.params[k], before[k])]
    assert any("input_proj_conv_adapter" in k for k in moved), moved


def test_replay_iteration_without_a_batch_is_text_only():
    """Where `image_batch_fn` gives None, the iteration is the text replay's
    own: `image_loss_fn` is not called, and two such iterations leave every
    tensor bitwise as two iterations without the hooks do."""
    tp = TinyPair(enc_layers=1, dec_layers=1)
    tok = tiny_tokenizer()
    results = []
    for hooks in ({}, {"image_batch_fn": lambda: None,
                       "image_loss_fn": lambda m, b: pytest.fail("called without a batch")}):
        model = build_model(port_config(tp.cfg), device="cpu", dtype="float32")
        model.load_state_dict(tp.port.state_dict(), strict=True)
        pm = _memory(model, tok)
        state = pinc.IncrementalState(params=pinc.snapshot(model), prompt_memory=pm,
                                      learned_classes=list(CLASSES))
        results.append(pinc.run_replay_phase(state, model, tok, iters=2, **hooks).params)
    for k, v in results[0].items():
        assert torch.equal(v, results[1][k]), k
