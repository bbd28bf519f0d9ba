"""The port's ZiRa lifecycle against the JAX package's, f32 on the CPU, at
`tiny_config` with `TinyPair`'s seeded weights (the ZiRa branches, freeze
branches and scalings all non-zero):

* `rep_merge` with the config's scaling resets (1e-6), and its algebra on
  the port: deterministic train-mode detections before the merge equal the
  eval-mode ones after it (1e-4, query selection pinned);
* `TextEncoderOnly`, `add_cls_prompt`, `build_prompt_injection` and a
  forward with prompt injection;
* the text replay: `replay_memory_loss` and its gradients, and two
  iterations of `run_replay_phase`;
* caption augmentation, the config overrides, and `load_model` keeping a
  checkpoint's prompt memory.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.torch_common import TinyPair, assert_close, port_config, torch_text, tiny_pair  # noqa: F401
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.models import transformer as ptransformer
from ziragroundingdino_torch.models import zira as pzira
from ziragroundingdino_torch.models.groundingdino import TextEncoderOnly
from ziragroundingdino_torch.train import incremental as pinc
from ziragroundingdino_torch.weights import jax_params_to_state_dict
from ziragroundingdino_tpu.models import zira as jzira
from ziragroundingdino_tpu.models.groundingdino import TextEncoderOnly as JTextEncoderOnly
from ziragroundingdino_tpu.train import incremental as jinc

MERGE_TOL = 1e-6  # one multiply-add per element, in f32
ALGEBRA_TOL = 1e-4  # whole forward: two matmuls against one, then 2 + 2 layers
TEXT_TOL = 1e-5  # the text path (BERT, feat_map, the language branch) and its gradients
CLASSES = ["cat", "dog", "zebra"]


def _port_copy(tp, **overrides):
    cfg = port_config(tp.cfg)
    model = build_model(cfg.replace(**overrides) if overrides else cfg, device="cpu",
                        dtype="float32")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    return model


def _state_dicts_close(got, want, tol, what):
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k].numpy(), tol, what=f"{what}: {k}")


def test_rep_merge_matches_jax():
    """Merge with non-default scaling inits: every tensor of the merged
    state dict equals the JAX merge's, carried over by the weight bridge."""
    tp = TinyPair(zira_lan_scale=0.3, zira_vis_scale=0.05)
    merged = jzira.rep_merge(tp.params, scale_reset=jzira.scale_reset_for_cfg(tp.cfg))
    model = _port_copy(tp)
    names = pzira.rep_merge(model, scale_reset=pzira.scale_reset_for_cfg(model.cfg))
    assert names == ["rep_linear_adapter"] + [f"input_proj_conv_adapter.{i}" for i in range(4)]
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, merged))
    _state_dicts_close(model.state_dict(), want, MERGE_TOL, "merged")
    sd = model.state_dict()
    assert torch.all(sd["rep_linear_adapter.scaling"] == 0.3)
    assert torch.all(sd["input_proj_conv_adapter.2.scaling"] == 0.05)
    assert torch.all(sd["input_proj_conv_adapter.2.weight"] == pzira.ZERO_VALUE)


def test_merge_algebra_train_equals_merged_eval(tiny_pair, monkeypatch):
    """Deterministic train mode (freeze + scaling * branch) before the merge
    gives the detections that eval mode (freeze only) gives after it; the
    eval run selects the queries the train run selected."""
    tp = tiny_pair
    model = _port_copy(tp)
    px, m, text = torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask), torch_text(tp.tb)
    with torch.no_grad():
        before = model(px, m, text, train=True)
        unmerged_eval = model(px, m, text)
        pzira.rep_merge(model, scale_reset=pzira.scale_reset_for_cfg(model.cfg))
        monkeypatch.setattr(ptransformer, "select_topk", lambda s, k: before["topk_idx"])
        after = model(px, m, text)
    for k in ("pred_logits", "pred_boxes", "encoded_text"):
        assert_close(after[k], before[k].numpy(), ALGEBRA_TOL, what=k)
    # the branches matter: without the merge, eval mode misses them
    assert (unmerged_eval["encoded_text"] - before["encoded_text"]).abs().max() > 10 * ALGEBRA_TOL


@pytest.fixture(scope="module")
def text_setup(tiny_pair):
    tp = tiny_pair
    tok = tiny_tokenizer()
    model = _port_copy(tp)
    return tp, tok, model


@pytest.mark.parametrize("train", [False, True])
def test_text_encoder_only_matches_jax(text_setup, train):
    tp, _, model = text_setup
    want, want_loss = JTextEncoderOnly(tp.cfg).apply({"params": tp.params}, tp.text, train=train)
    with torch.no_grad():
        got, loss = TextEncoderOnly(model)(torch_text(tp.tb), train=train)
    assert_close(got, want, TEXT_TOL, what="encoded_text")
    assert_close(loss, want_loss, TEXT_TOL, what="adapter loss")
    enc = TextEncoderOnly(model)
    assert enc.bert is model.bert and enc.rep_linear_adapter is model.rep_linear_adapter


def test_prompt_capture_and_injection_match_jax(text_setup):
    """`add_cls_prompt` stores the same embeddings; the injection built from
    them is the same, and a forward with it gives the same detections."""
    tp, tok, model = text_setup
    want = jinc.add_cls_prompt({"-fish-": np.ones((1, 64), np.float32)}, tp.cfg, tp.params, tok,
                               CLASSES, max_text_len=32)
    got = pinc.add_cls_prompt({"-fish-": np.ones((1, 64), np.float32)}, model, tok, CLASSES,
                              max_text_len=32)
    assert got.keys() == want.keys() == {"-fish-", "-cat-", "-dog-", "-zebra-"}
    for k in want:
        assert got[k].shape == want[k].shape
        assert_close(got[k], want[k], TEXT_TOL, what=k)

    names = [["cat", "dog"], ["zebra", "person", "fish"]]
    c2t = tp.tb.cate_to_token_mask
    jv, jm = jinc.build_prompt_injection(want, names, c2t, 64)
    pv, pm = pinc.build_prompt_injection(got, names, c2t, 64)
    np.testing.assert_array_equal(pm, jm)
    assert jm.sum() == 4  # cat, dog, zebra, fish; person was never stored
    assert_close(pv, jv, TEXT_TOL, what="injected values")

    jout = jax.jit(lambda p: tp.jmodel.apply(
        {"params": p}, jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text,
        prompt_replace_values=jnp.asarray(jv), prompt_replace_mask=jnp.asarray(jm)))(tp.params)
    with torch.no_grad():
        pout = model(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask), torch_text(tp.tb),
                     prompt_replace_values=torch.from_numpy(pv),
                     prompt_replace_mask=torch.from_numpy(pm))
    # the logits at the whole forward's tolerance (`tests/test_torch_model.py`:
    # they differ by up to ~2e-5 here), the rest at the text path's
    assert_close(pout["pred_logits"], jout["pred_logits"], ALGEBRA_TOL, what="injected logits")
    for k in ("pred_boxes", "encoded_text"):
        assert_close(pout[k], jout[k], TEXT_TOL, what=f"injected forward {k}")
    # the injection took effect: the encoded text differs from a plain forward's
    with torch.no_grad():
        plain = model(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask), torch_text(tp.tb))
    assert (plain["encoded_text"] - pout["encoded_text"]).abs().max() > 1e-2


def _memory(tp, tok, model):
    """A prompt memory of CLASSES away from the current features, so the
    replay loss and its gradients are not zero."""
    pm = pinc.add_cls_prompt({}, model, tok, CLASSES, max_text_len=32)
    rng = np.random.RandomState(3)
    return {k: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32) for k, v in pm.items()}


def test_replay_memory_loss_and_grads_match_jax(text_setup):
    tp, tok, model = text_setup
    pm = _memory(tp, tok, model)
    learned = CLASSES + ["fish"]  # fish has no stored embedding

    def jtotal(p):
        losses = jinc.replay_memory_loss(tp.cfg, p, tok, learned, pm, 32)
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, jlosses), jgrads = jax.value_and_grad(jtotal, has_aux=True)(tp.params)
    model.zero_grad(set_to_none=True)
    losses = pinc.replay_memory_loss(model, tok, learned, pm, 32)
    assert losses.keys() == jlosses.keys()
    for k in jlosses:
        assert_close(losses[k], jlosses[k], TEXT_TOL, what=k)
    sum(losses.values()).backward()
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    names = [n for n, p in model.named_parameters() if "rep_linear_adapter" in n]
    assert len(names) == 5
    for n in names:
        g = dict(model.named_parameters())[n].grad
        scale = max(1.0, float(want[n].abs().max()))
        assert float(want[n].abs().max()) > 0, n
        assert_close(g / scale, want[n].numpy() / scale, TEXT_TOL, what=f"grad {n}")
    model.zero_grad(set_to_none=True)


def test_replay_phase_matches_jax(tiny_pair):
    """Two replay iterations (AdamW at optax.adamw's defaults, then the
    merge): every parameter as JAX's run_replay_phase leaves it."""
    tp = tiny_pair
    tok = tiny_tokenizer()
    model = _port_copy(tp)
    pm = _memory(tp, tok, model)
    jstate = jinc.IncrementalState(params=tp.params, prompt_memory=dict(pm),
                                   learned_classes=list(CLASSES))
    jstate = jinc.run_replay_phase(jstate, tp.cfg, tok, iters=2)
    state = pinc.IncrementalState(params=pinc.snapshot(model), prompt_memory=dict(pm),
                                  learned_classes=list(CLASSES))
    state = pinc.run_replay_phase(state, model, tok, iters=2)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    _state_dicts_close(state.params, want, TEXT_TOL, "after replay")
    before = tp.port.state_dict()
    assert not torch.equal(state.params["rep_linear_adapter.freeze_linear.weight"],
                           before["rep_linear_adapter.freeze_linear.weight"])


@pytest.mark.parametrize("learned,num_select,seed", [
    (["cat", "dog", "fish"], 20, None),
    (["zebra", "cat", "car", "fish", "person"], 2, 5),
    (["zebra", "car"], 2, 5),
    ([], 20, 0),
])
def test_caption_augmentation_matches_jax(learned, num_select, seed):
    def rng():
        return None if seed is None else np.random.RandomState(seed)

    want = jinc.augment_caption_with_learned_names(["cat", "dog"], learned, num_select, rng())
    got = pinc.augment_caption_with_learned_names(["cat", "dog"], learned, num_select, rng())
    assert got == want


def test_config_overrides_match_jax(tmp_path):
    from ziragroundingdino_torch import config as pconfig
    from ziragroundingdino_tpu import config as jconfig

    path = tmp_path / "ov.json"
    path.write_text(json.dumps({
        "model": {"hidden_dim": 64, "use_add_names": True, "return_interm_indices": [1, 2, 3],
                  "swin_config": {"embed_dim": 8, "depths": [1, 1, 1, 1]},
                  "bert_config": {"hidden_size": 32, "num_hidden_layers": 2}},
        "data": {"train_short_sides": [64, 96], "shape_buckets": [[96, 128], [128, 160]]}}))
    pm, pd = pconfig.load_config_overrides(str(path))
    jm, jd = jconfig.load_config_overrides(str(path))
    assert pd == jd and pm.keys() == jm.keys()
    for k in pm:
        if k in ("swin_config", "bert_config"):
            for f in dataclasses.fields(pm[k]):
                assert getattr(pm[k], f.name) == getattr(jm[k], f.name), (k, f.name)
        else:
            assert pm[k] == jm[k], k
    pcfg = pconfig.get_model_config("dualzerorepbranchgroundingdino", **pm)
    jcfg = jconfig.get_model_config("dualzerorepbranchgroundingdino", **jm)
    assert pcfg.use_add_names and pcfg.swin.depths == jcfg.swin.depths
    assert pconfig.DataConfig(**pd).train_short_sides == jconfig.DataConfig(**jd).train_short_sides


def test_load_model_keeps_prompt_memory(tiny_pair, tmp_path):
    """A reference-format checkpoint's `prompt_memory_pool.<name>` entries
    come back as `LoadedModel.prompt_memory` (as the JAX package's converter
    returns them), and the weights load strictly beside them."""
    from ziragroundingdino_torch.data.synthetic import write_vocab
    from ziragroundingdino_torch.utils.inference import load_model
    from ziragroundingdino_tpu.utils.torch_convert import load_torch_checkpoint

    tp = tiny_pair
    rng = np.random.RandomState(0)
    memory = {"-cat-": rng.randn(1, 64).astype(np.float32),
              "-traffic light-": rng.randn(3, 64).astype(np.float32)}
    sd = dict(tp.port.state_dict())
    sd.update({f"prompt_memory_pool.{k}": torch.from_numpy(v) for k, v in memory.items()})
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, ckpt)
    vocab = tmp_path / "vocab.txt"
    write_vocab(str(vocab), tiny_tokenizer().vocab)

    lm = load_model(str(ckpt), str(vocab), device="cpu", **_port_fields(tp))
    _, _, jmemory, _ = load_torch_checkpoint(str(ckpt))
    assert lm.prompt_memory.keys() == jmemory.keys() == memory.keys()
    for k, v in memory.items():
        np.testing.assert_array_equal(lm.prompt_memory[k], v)
        np.testing.assert_array_equal(jmemory[k], v)
    for k, v in lm.model.state_dict().items():
        assert torch.equal(v, tp.port.state_dict()[k]), k
    assert lm.tokenizer.vocab == tiny_tokenizer().vocab


def _port_fields(tp):
    """The tiny config as build_model overrides of the preset."""
    cfg = port_config(tp.cfg)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
