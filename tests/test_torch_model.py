"""The whole serving slice: the JAX `GroundingDINO.apply` against the port's
forward at `tiny_config` (batch 2, padded images, two captions), f32 on the
CPU, with the same seeded parameters (through the weight bridge).

Top-k query selection is discontinuous, so the comparison goes in order:
the encoder memory before selection (1e-4), then the selected indices
(equal), then the detections (`pred_logits`, `pred_boxes`: 1e-4), then
what `predict` / `predict_classes` return.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.torch_common import assert_close, port_config, torch_text, tiny_pair  # noqa: F401
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_tpu.utils import inference as jinf
from ziragroundingdino_torch.utils import inference as pinf
from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer

ATOL = 1e-4


@pytest.fixture(scope="module")
def outputs(tiny_pair):
    tp = tiny_pair
    fwd = jax.jit(lambda p, px, m, t: tp.jmodel.apply(
        {"params": p}, px, m, t, capture_intermediates=True))
    jout, inter = fwd(tp.params, jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text)
    inter = inter["intermediates"]
    captured = {}
    hook = tp.port.transformer.encoder.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("encoder", out))
    try:
        with torch.inference_mode():
            pout = tp.port(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask),
                           torch_text(tp.tb))
    finally:
        hook.remove()
    return jout, inter, pout, captured


def test_encoder_memory(outputs):
    _, inter, _, captured = outputs
    jmem, jtext, _ = inter["transformer"]["encoder"]["__call__"][0]
    memory, memory_text, adapter_loss = captured["encoder"]
    assert adapter_loss.item() == 0.0  # the preset has no in-layer adapter
    assert_close(memory, jmem, ATOL, what="image memory")
    assert_close(memory_text, jtext, ATOL, what="text memory")


def test_topk_indices(tiny_pair, outputs):
    _, inter, pout, _ = outputs
    # the shared class head's first call scores the encoder memory
    enc_logits = inter["class_embed"]["__call__"][0]
    _, jidx = jax.lax.top_k(jnp.max(enc_logits, axis=-1), tiny_pair.cfg.num_queries)
    np.testing.assert_array_equal(pout["topk_idx"].numpy(), np.asarray(jidx))


def test_detections(tiny_pair, outputs):
    jout, _, pout, _ = outputs
    q, t = tiny_pair.cfg.num_queries, tiny_pair.cfg.max_text_len
    assert pout["pred_logits"].shape == (2, q, t) and pout["pred_boxes"].shape == (2, q, 4)
    assert_close(pout["pred_logits"], jout["pred_logits"], ATOL, what="pred_logits")
    assert_close(pout["pred_boxes"], jout["pred_boxes"], ATOL, what="pred_boxes")
    assert_close(pout["encoded_text"], jout["encoded_text"], ATOL, what="encoded_text")
    # the box head's last layer is non-zero here, so boxes move off the anchors
    assert np.abs(np.asarray(jout["pred_boxes"]) - 0.5).max() > 1e-3


def test_predict_and_predict_classes(tiny_pair):
    """The user entry points on image 0: same boxes, scores and phrases (or
    class names) as the JAX package's."""
    tp = tiny_pair
    jtok = tiny_tokenizer()
    jlm = jinf.LoadedModel(model=tp.jmodel, params={"params": tp.params}, tokenizer=jtok,
                           cfg=tp.cfg, prompt_memory={})
    plm = pinf.LoadedModel(model=tp.port, tokenizer=WordPieceTokenizer(dict(jtok.vocab)))
    px, m = tp.pixels[:1], tp.mask[:1]
    kw = dict(box_threshold=0.3, text_threshold=0.25)
    want = jinf.predict(jlm, jnp.asarray(px), jnp.asarray(m), "Zebra . cat", **kw)
    got = pinf.predict(plm, px, m, "Zebra . cat", **kw)
    assert len(want[0]) > 0 and got[2] == want[2]
    assert_close(got[0], want[0], ATOL, what="boxes")
    assert_close(got[1], want[1], ATOL, what="scores")

    names = ["cat", "dog", "fish"]
    want = jinf.predict_classes(jlm, jnp.asarray(px), jnp.asarray(m), names, box_threshold=0.3)
    got = pinf.predict_classes(plm, px, m, names, box_threshold=0.3)
    assert len(want[0]) > 0 and got[2] == want[2]
    assert_close(got[0], want[0], ATOL, what="class boxes")
    assert_close(got[1], want[1], ATOL, what="class scores")


def test_bfloat16_forward(tiny_pair, outputs):
    """The serving dtype on the CPU: the same weights in bf16 compute give
    finite detections of the same shape, boxes in [0, 1]. (Top-k selection
    is discontinuous, so bf16 and f32 may pick other queries.)"""
    tp = tiny_pair
    model = build_model(port_config(tp.cfg), device="cpu", dtype="bfloat16")
    model.load_state_dict(tp.port.state_dict(), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask), torch_text(tp.tb))
    f32 = outputs[2]
    assert out["pred_logits"].dtype == torch.float32
    for k in ("pred_logits", "pred_boxes"):
        assert out[k].shape == f32[k].shape and torch.isfinite(out[k]).all(), k
    assert ((out["pred_boxes"] >= 0) & (out["pred_boxes"] <= 1)).all()
