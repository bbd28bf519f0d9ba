"""Per-module parity of the PyTorch port against the JAX package, f32 on the
CPU, at `tests/common.py::tiny_config`.

Every module of the port gets the JAX module's parameters (seeded, through
the weight bridge: the port modules are those of a port model loaded with
the whole parameter tree) and the same numpy inputs. Tolerance: 1e-4 abs
(f32 matmul accumulation order differs between XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.torch_common import assert_close, tiny_pair  # noqa: F401  (fixture)
from ziragroundingdino_torch import config as pconfig
from ziragroundingdino_torch.data import transforms as tforms
from ziragroundingdino_tpu import config as jconfig
from ziragroundingdino_tpu.data import transforms as jtforms
from ziragroundingdino_tpu.models import fusion as jfusion
from ziragroundingdino_tpu.models import groundingdino as jgd
from ziragroundingdino_tpu.models import heads as jheads
from ziragroundingdino_tpu.models import layers as jlayers
from ziragroundingdino_tpu.models import position_encoding as jpos
from ziragroundingdino_tpu.models import swin as jswin
from ziragroundingdino_tpu.models import transformer as jtr
from ziragroundingdino_tpu.models import zira as jzira
from ziragroundingdino_tpu.models.bert import BertEncoder as JBert
from ziragroundingdino_tpu.text import masks as jmasks
from ziragroundingdino_tpu.text import tokenizer as jtok
from ziragroundingdino_torch.models import layers as players
from ziragroundingdino_torch.models import position_encoding as ppos
from ziragroundingdino_torch.models import swin as pswin
from ziragroundingdino_torch.models import transformer as ptr
from ziragroundingdino_torch.models.heads import ContrastiveEmbed
from ziragroundingdino_torch.ops import box_ops as pbox
from ziragroundingdino_torch.text import masks as pmasks
from ziragroundingdino_torch.text import tokenizer as ptok

ATOL = 1e-4
F32 = jnp.float32
SHAPES = ((8, 12), (4, 6), (2, 3), (1, 2))  # the tiny model's levels at 64x96
S = sum(h * w for h, w in SHAPES)


def _t(x):
    return torch.from_numpy(np.array(x))


def japply(module, variables, *args, **kw):
    """`module.apply` under jit (tuple arguments static): a jitted apply
    compiles faster than the eager one dispatches."""
    static = tuple(i + 1 for i, a in enumerate(args) if isinstance(a, tuple))
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw), static_argnums=static)(
        variables, *args)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _level_masks(b=2):
    """Per-level validity masks with right/bottom padding in item 1."""
    out = []
    for h, w in SHAPES:
        m = np.ones((b, h, w), bool)
        m[1, max(1, (3 * h) // 4):, :] = False
        m[1, :, max(1, (3 * w) // 4):] = False
        out.append(m)
    return out


def _memory_mask(b=2):
    return np.concatenate([m.reshape(b, -1) for m in _level_masks(b)], axis=1)


def _text(tp):
    ids = tp.tb.input_ids
    return (ids, tp.tb.text_token_mask, tp.tb.position_ids, tp.tb.text_self_attention_masks)


def test_swin(tiny_pair):
    tp = tiny_pair
    want = japply(jswin.SwinTransformer(tp.cfg.swin, dtype=F32),
        {"params": tp.params["backbone"]}, jnp.asarray(tp.pixels), jnp.asarray(tp.mask))
    with torch.inference_mode():
        got = tp.port.backbone[0](_t(tp.pixels), _t(tp.mask))
    assert len(got) == len(want)
    for (gf, gm), (wf, wm) in zip(got, want):
        assert_close(gf, wf, ATOL, what="swin feature")
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_bert(tiny_pair):
    tp = tiny_pair
    ids, _, pos, attn = _text(tp)
    want = japply(JBert(tp.cfg.bert, dtype=F32),
        {"params": tp.params["bert"]}, jnp.asarray(ids), jnp.asarray(attn),
        position_ids=jnp.asarray(pos))
    with torch.inference_mode():
        got = tp.port.bert(_t(ids), _t(attn), position_ids=_t(pos))
    assert_close(got, want, ATOL)


def test_bi_attention_block(tiny_pair):
    tp = tiny_pair
    cfg = tp.cfg
    rng = _rng(1)
    _, tmask, _, _ = _text(tp)
    v = rng.randn(2, S, cfg.hidden_dim).astype(np.float32)
    l_ = rng.randn(2, tmask.shape[1], cfg.hidden_dim).astype(np.float32)
    mv = _memory_mask()
    want = japply(jfusion.BiAttentionBlock(
        v_dim=cfg.hidden_dim, l_dim=cfg.hidden_dim, embed_dim=cfg.dim_feedforward // 2,
        num_heads=cfg.nheads // 2, dtype=F32,
    ), {"params": tp.params["transformer"]["encoder"]["fusion_layers_0"]},
            jnp.asarray(v), jnp.asarray(l_), jnp.asarray(mv), jnp.asarray(tmask))
    with torch.inference_mode():
        got = tp.port.transformer.encoder.fusion_layers[0](_t(v), _t(l_), _t(mv), _t(tmask))
    assert_close(got[0], want[0], ATOL, what="vision")
    assert_close(got[1], want[1], ATOL, what="text")


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_msdeform_attn(tiny_pair, side):
    """Encoder: 2-D reference points per level; decoder: 4-D boxes."""
    tp = tiny_pair
    cfg = tp.cfg
    rng = _rng(2)
    q = 10
    query = rng.randn(2, q, cfg.hidden_dim).astype(np.float32)
    value = rng.randn(2, S, cfg.hidden_dim).astype(np.float32)
    nref = 2 if side == "encoder" else 4
    ref = rng.rand(2, q, cfg.num_feature_levels, nref).astype(np.float32)
    mask = _memory_mask()
    name = ("layers_0", "self_attn") if side == "encoder" else ("layers_0", "cross_attn")
    want = japply(jtr.MSDeformAttn(
        embed_dim=cfg.hidden_dim, num_heads=cfg.nheads, num_levels=cfg.num_feature_levels,
        num_points=4, impl="xla", dtype=F32,
    ), {"params": tp.params["transformer"][side][name[0]][name[1]]},
            jnp.asarray(query), jnp.asarray(value), jnp.asarray(ref), SHAPES, jnp.asarray(mask))
    layer = getattr(tp.port.transformer, side).layers[0]
    mod = layer.self_attn if side == "encoder" else layer.cross_attn
    with torch.inference_mode():
        got = mod(_t(query), _t(value), _t(ref), SHAPES, _t(mask))
    assert_close(got, want, ATOL)


def test_encoder_and_text_layers(tiny_pair):
    tp = tiny_pair
    cfg = tp.cfg
    rng = _rng(3)
    src = rng.randn(2, S, cfg.hidden_dim).astype(np.float32)
    pos = rng.randn(2, S, cfg.hidden_dim).astype(np.float32)
    masks = _level_masks()
    vr = np.asarray(jtr.compute_valid_ratios([jnp.asarray(m) for m in masks]))
    ref = np.asarray(jtr.encoder_reference_points(SHAPES, jnp.asarray(vr)))
    mask = _memory_mask()
    enc = tp.params["transformer"]["encoder"]
    want, _ = japply(jtr.DeformableEncoderLayer(cfg, dtype=F32),
        {"params": enc["layers_0"]}, jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref),
        SHAPES, jnp.asarray(mask))
    with torch.inference_mode():
        got, loss = tp.port.transformer.encoder.layers[0](_t(src), _t(pos), _t(ref), SHAPES,
                                                          _t(mask))
    assert_close(got, want, ATOL, what="deformable encoder layer")
    assert loss.item() == 0.0  # no in-layer adapter

    _, tmask, tpos, tattn = _text(tp)
    text = rng.randn(2, tmask.shape[1], cfg.hidden_dim).astype(np.float32)
    pos_text = rng.randn(*text.shape).astype(np.float32)
    want = japply(jtr.TextEnhancerLayer(cfg, dtype=F32),
        {"params": enc["text_layers_0"]}, jnp.asarray(text), jnp.asarray(tattn),
        jnp.asarray(pos_text))
    with torch.inference_mode():
        got = tp.port.transformer.encoder.text_layers[0](_t(text), _t(tattn), _t(pos_text))
    assert_close(got, want, ATOL, what="text enhancer layer")


def test_decoder_layer(tiny_pair):
    tp = tiny_pair
    cfg = tp.cfg
    rng = _rng(4)
    q = cfg.num_queries
    tgt = rng.randn(2, q, cfg.hidden_dim).astype(np.float32)
    qpos = rng.randn(2, q, cfg.hidden_dim).astype(np.float32)
    ref = rng.rand(2, q, cfg.num_feature_levels, 4).astype(np.float32)
    memory = rng.randn(2, S, cfg.hidden_dim).astype(np.float32)
    mmask = _memory_mask()
    _, tmask, _, _ = _text(tp)
    text = rng.randn(2, tmask.shape[1], cfg.hidden_dim).astype(np.float32)
    want, _ = japply(jtr.DeformableDecoderLayer(cfg, dtype=F32),
        {"params": tp.params["transformer"]["decoder"]["layers_0"]},
        jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(ref), jnp.asarray(memory),
        jnp.asarray(mmask), SHAPES, jnp.asarray(text), jnp.asarray(tmask))
    with torch.inference_mode():
        got, loss = tp.port.transformer.decoder.layers[0](
            _t(tgt), _t(qpos), _t(ref), _t(memory), _t(mmask), SHAPES, _t(text), _t(tmask))
    assert_close(got, want, ATOL)
    assert loss.item() == 0.0  # no in-layer adapter


def test_heads_and_zira(tiny_pair):
    """ContrastiveEmbed, RepZeroLinear, RepZeroConv (1x1 and 3x3/s2) and the
    input projection with its GroupNorm (eval forwards)."""
    tp = tiny_pair
    cfg = tp.cfg
    rng = _rng(5)
    _, tmask, _, _ = _text(tp)
    x = rng.randn(2, 7, cfg.hidden_dim).astype(np.float32)
    y = rng.randn(2, tmask.shape[1], cfg.hidden_dim).astype(np.float32)
    want = japply(jheads.ContrastiveEmbed(max_text_len=cfg.max_text_len, dtype=F32),
        {}, jnp.asarray(x), {"encoded_text": jnp.asarray(y), "text_token_mask": jnp.asarray(tmask)})
    got = ContrastiveEmbed(cfg.max_text_len)(
        _t(x), {"encoded_text": _t(y), "text_token_mask": _t(tmask)})
    assert_close(got, want, ATOL, what="contrastive embed")

    xb = rng.randn(2, 5, cfg.bert.hidden_size).astype(np.float32)
    want, _ = japply(jzira.RepZeroLinear(features=cfg.hidden_dim, dtype=F32),
        {"params": tp.params["rep_linear_adapter"]}, jnp.asarray(xb))
    with torch.inference_mode():
        got = tp.port.rep_linear_adapter(_t(xb))
    assert_close(got, want, ATOL, what="RepZeroLinear")

    c_in = tp.cfg.swin.num_features[-1]
    feat = rng.randn(2, 4, 6, c_in).astype(np.float32)
    for lvl, ks, stride in ((2, 1, 1), (3, 3, 2)):
        want, _ = japply(jzira.RepZeroConv(features=cfg.hidden_dim, kernel_size=ks, stride=stride,
                                    dtype=F32),
            {"params": tp.params[f"input_proj_conv_adapter_{lvl}"]}, jnp.asarray(feat))
        jproj = jgd.InputProj(cfg.hidden_dim, kernel_size=ks, stride=stride, dtype=F32)
        want_proj = japply(jproj, {"params": tp.params[f"input_proj_{lvl}"]}, jnp.asarray(feat),
                                want)
        with torch.inference_mode():
            got = tp.port.input_proj_conv_adapter[lvl](_t(feat))
            got_proj = tp.port.input_proj[lvl](_t(feat), got)
        assert_close(got, want, ATOL, what=f"RepZeroConv {ks}x{ks}")
        assert_close(got_proj, want_proj, ATOL, what=f"InputProj {ks}x{ks}")


def test_multihead_attention_masks(tiny_pair):
    """Decoder text cross-attention (key padding) and text self-attention
    (3-D block-diagonal mask)."""
    tp = tiny_pair
    cfg = tp.cfg
    rng = _rng(6)
    _, tmask, _, tattn = _text(tp)
    q = rng.randn(2, 9, cfg.hidden_dim).astype(np.float32)
    kv = rng.randn(2, tmask.shape[1], cfg.hidden_dim).astype(np.float32)
    p = tp.params["transformer"]["decoder"]["layers_0"]["ca_text"]
    want = japply(jlayers.MultiHeadAttention(num_heads=cfg.nheads, dtype=F32),
        {"params": p}, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
        key_padding_mask=jnp.asarray(tmask))
    with torch.inference_mode():
        got = tp.port.transformer.decoder.layers[0].ca_text(
            _t(q), _t(kv), _t(kv), key_padding_mask=_t(tmask))
    assert_close(got, want, ATOL, what="key padding")
    p = tp.params["transformer"]["encoder"]["text_layers_0"]["self_attn"]
    want = japply(jlayers.MultiHeadAttention(num_heads=cfg.nheads // 2, dtype=F32),
        {"params": p}, jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(kv),
        attn_mask=jnp.asarray(tattn))
    with torch.inference_mode():
        got = tp.port.transformer.encoder.text_layers[0].self_attn(
            _t(kv), _t(kv), _t(kv), attn_mask=_t(tattn))
    assert_close(got, want, ATOL, what="3-D mask")


def _fn_cases():
    rng = _rng(7)
    masks = _level_masks()
    mem = rng.randn(2, S, 8).astype(np.float32)
    vr = rng.uniform(0.5, 1.0, (2, len(SHAPES), 2)).astype(np.float32)
    pos4 = rng.rand(2, 5, 4).astype(np.float32)
    pos1 = rng.randint(0, 9, (2, 6, 1)).astype(np.float32)
    probs = rng.uniform(-0.1, 1.1, (3, 7)).astype(np.float32)
    big = np.ones((2, 13, 19), bool)
    big[0, 10:] = False
    return {
        "get_sine_pos_embed": (
            lambda m: m.get_sine_pos_embed(pos1, num_pos_feats=16, exchange_xy=False),
            lambda m: m.get_sine_pos_embed(pos4[..., :2], num_pos_feats=8)),
        "gen_sineembed_for_position": (
            lambda m: m.gen_sineembed_for_position(pos4, num_feats=16),
            lambda m: m.gen_sineembed_for_position(pos4[..., :2], num_feats=8)),
        "inverse_sigmoid": (lambda m: m.inverse_sigmoid(probs),),
        "position_embedding_sine_hw": (
            lambda m: m.position_embedding_sine_hw(masks[0], num_pos_feats=16),),
        "compute_valid_ratios": (lambda m: m.compute_valid_ratios(masks),),
        "encoder_reference_points": (lambda m: m.encoder_reference_points(SHAPES, vr),),
        "gen_encoder_output_proposals": (
            lambda m: m.gen_encoder_output_proposals(mem, _memory_mask(), SHAPES),),
        "interpolate_mask_nearest": (lambda m: m.interpolate_mask_nearest(big, 4, 7),),
    }


_FN_MODULES = {
    "get_sine_pos_embed": (jlayers, players), "gen_sineembed_for_position": (jlayers, players),
    "inverse_sigmoid": (jlayers, pbox),
    "position_embedding_sine_hw": (jpos, ppos), "compute_valid_ratios": (jtr, ptr),
    "encoder_reference_points": (jtr, ptr), "gen_encoder_output_proposals": (jtr, ptr),
    "interpolate_mask_nearest": (jswin, pswin),
}


class _Args:
    """Calls a module's function with numpy arguments converted for it."""

    def __init__(self, mod, conv):
        self.mod, self.conv = mod, conv

    def __getattr__(self, name):
        fn = getattr(self.mod, name)

        def call(*args, **kw):
            conv = self.conv
            args = [tuple(conv(a) for a in x) if isinstance(x, list) else
                    (conv(x) if isinstance(x, np.ndarray) else x) for x in args]
            return fn(*args, **kw)

        return call


@pytest.mark.parametrize("name", sorted(_FN_MODULES))
def test_functions(name):
    jmod, pmod = _FN_MODULES[name]
    for case in _fn_cases()[name]:
        want = case(_Args(jmod, jnp.asarray))
        got = case(_Args(pmod, torch.from_numpy))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert_close(g, w, 1e-5)


def test_text_masks_and_tokenizer():
    """Host text path: same ids, block-diagonal masks, position ids and
    category maps at batch 2; per-category logits."""
    captions = ["cat.dog.", "zebra. person.fish .", "car"]
    jt = tiny_tokenizer()
    pt = ptok.WordPieceTokenizer(ptok.make_synthetic_vocab(
        ["cat", "dog", "zebra", "person", "fish", "car"]))
    assert pt.vocab == jt.vocab
    want = jtok.tokenize_captions(jt, captions, max_text_len=32, max_categories=4,
                                  text_len_buckets=(16, 32))
    got = ptok.tokenize_captions(pt, captions, max_text_len=32, max_categories=4,
                                 text_len_buckets=(16, 32))
    for field in ("input_ids", "text_token_mask", "position_ids", "text_self_attention_masks",
                  "cate_to_token_mask", "num_categories"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert ptok.build_captions(["a", "b"]) == jtok.build_captions(["a", "b"])
    rng = _rng(8)
    logits = rng.randn(3, 5, got.input_ids.shape[1]).astype(np.float32)
    want = jmasks.recover_to_cls_logits(jnp.asarray(logits), jnp.asarray(want.cate_to_token_mask))
    got = pmasks.recover_to_cls_logits(_t(logits), _t(got.cate_to_token_mask))
    assert_close(got, want, 0.0)


def test_config_preset_and_host_transforms():
    """The port's copy of the preset and of the host image transforms
    matches the JAX package's, field by field and bit for bit."""
    jcfg = jconfig.get_model_config("dualzerorepbranchgroundingdino")
    pcfg = pconfig.get_model_config("dualzerorepbranchgroundingdino")
    for port_obj, jax_obj in ((pcfg, jcfg), (pcfg.swin, jcfg.swin), (pcfg.bert, jcfg.bert)):
        for f in dataclasses.fields(port_obj):
            if f.name not in ("swin_config", "bert_config"):
                assert getattr(port_obj, f.name) == getattr(jax_obj, f.name), f.name
    assert pcfg.torch_dtype == torch.bfloat16

    jdata, pdata = jconfig.DataConfig(), pconfig.DataConfig()
    assert pdata.shape_buckets == jdata.shape_buckets
    image = _rng(9).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    for h, w in ((37, 53), (800, 1199), (801, 1000), (2000, 2000)):
        assert tforms.pick_bucket(h, w, pdata.shape_buckets) == jtforms.pick_bucket(
            h, w, jdata.shape_buckets)
    np.testing.assert_array_equal(tforms.normalize(image, pdata), jtforms.normalize(image, jdata))
    bucket = tforms.pick_bucket(37, 53, ((32, 64), (48, 64), (64, 96)))
    for g, w in zip(tforms.pad_to_bucket(image, bucket), jtforms.pad_to_bucket(image, bucket)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="does not fit"):
        tforms.pad_to_bucket(image, (32, 64))
