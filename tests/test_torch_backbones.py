"""The port's architecture switches against the JAX package, f32 on the
CPU, with the same seeded parameters (through the weight bridge) and the
same numpy inputs: the Swin variants (every one of `SWIN_VARIANTS` at its
widths, heads and window, depth cut to a block a stage; a tiny Swin at
window 12 where every stage pads), ResNet-50/101 with frozen BN, the
learned position tables past their 50 rows, and the whole model at
`tiny_config` with each switch: ResNet, learned positions, window 12, and
each ablation switch off in turn. Top-k query selection is pinned as in
`tests/test_torch_model.py`: the selected indices must be JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import TINY_SWIN, tiny_config, tiny_image_batch
from tests.torch_common import TinyPair, assert_close, port_config, random_params, torch_text
from ziragroundingdino_torch import config as pc
from ziragroundingdino_torch.models.groundingdino import GroundingDINO
from ziragroundingdino_torch.models.position_encoding import PositionEmbeddingLearned
from ziragroundingdino_torch.models.resnet import ResNetBackbone
from ziragroundingdino_torch.models.swin import SwinTransformer
from ziragroundingdino_torch.weights import jax_params_to_state_dict
from ziragroundingdino_tpu import config as jc

SWIN_TOL = 1e-5  # a backbone alone, relative to its largest output
MODEL_TOL = 1e-4  # pred_logits / pred_boxes, as tests/test_torch_model.py
# TINY_SWIN at window 12 with two blocks a stage (the second shifted by 6)
W12_SWIN = dataclasses.replace(TINY_SWIN, window_size=12, depths=(2, 2, 2, 2))


def _port_swin(jswin) -> pc.SwinConfig:
    return pc.SwinConfig(**{f.name: getattr(jswin, f.name) for f in dataclasses.fields(jswin)})


def _backbone_state(params, body):
    """The bridge's `backbone.0.*` keys of a JAX backbone's parameters,
    loaded strictly into the port's backbone module `body`."""
    sd = jax_params_to_state_dict({"backbone": params})
    sd = {k[len("backbone.0."):]: v for k, v in sd.items()}
    body.load_state_dict(sd, strict=True)
    return body


def _run_backbone(jmodule, body, pixels, mask, seed=0):
    """JAX's and the port's outputs [(feature, mask)] on the same inputs."""
    px, m = jnp.asarray(pixels), jnp.asarray(mask)
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), px, m)
    params = random_params(shapes["params"], seed)
    want = jax.jit(lambda p: jmodule.apply({"params": p}, px, m))(params)
    _backbone_state(params, body)
    with torch.no_grad():
        got = body(torch.from_numpy(pixels), torch.from_numpy(mask))
    return got, want


def _check_levels(got, want, tol, what):
    assert len(got) == len(want)
    for lvl, ((f, m), (jf, jm)) in enumerate(zip(got, want)):
        assert f.shape == jf.shape, (what, lvl, f.shape, jf.shape)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        scale = max(1.0, float(np.abs(np.asarray(jf)).max()))
        assert_close(f, jf, tol * scale, what=f"{what} level {lvl}")


def test_variant_tables_match_jax():
    """`SWIN_VARIANTS` equal to JAX's field by field, the same five names;
    the ResNet depths equal to JAX's."""
    from ziragroundingdino_tpu.models.resnet import RESNET_DEPTHS

    assert set(pc.SWIN_VARIANTS) == set(jc.SWIN_VARIANTS)
    for name, v in jc.SWIN_VARIANTS.items():
        assert pc.SWIN_VARIANTS[name] == _port_swin(v), name
    assert pc.RESNET_DEPTHS == RESNET_DEPTHS
    # GroundingDINO-B: Swin-B at window 12, a (2 * 12 - 1)**2 bias table
    cfg = pc.GroundingDINOConfig(backbone="swin_B_384_22k")
    assert cfg.swin.window_size == 12 and cfg.swin.embed_dim == 128
    with torch.device("meta"):
        swin = SwinTransformer(cfg.swin)
    assert swin.layers[0].blocks[0].attn.relative_position_bias_table.shape == (529, 4)
    assert swin.out_channels == (256, 512, 1024)


@pytest.mark.parametrize("name", sorted(jc.SWIN_VARIANTS))
def test_swin_variant_matches_jax(name):
    """Each variant's widths, heads and window, one block a stage, on a
    64x96 image (stages 16x24 .. 2x3: window 12 pads every one)."""
    from ziragroundingdino_tpu.models.swin import SwinTransformer as JSwin

    jcfg = dataclasses.replace(jc.SWIN_VARIANTS[name], depths=(1, 1, 1, 1))
    pixels, mask = tiny_image_batch(b=1)
    got, want = _run_backbone(JSwin(jcfg, dtype=jnp.float32),
                              SwinTransformer(_port_swin(jcfg), torch.float32), pixels, mask)
    _check_levels(got, want, SWIN_TOL, name)


def test_window12_swin_pads_every_stage():
    """A tiny Swin at window 12, two blocks a stage (shift 6), on 128x160:
    the stages (32x40, 16x20, 8x10, 4x5) pad to 36x48, 24x24, 12x12,
    12x12; against JAX's, and the shift masks cached per padded shape."""
    from ziragroundingdino_tpu.models.swin import SwinTransformer as JSwin

    pixels, mask = tiny_image_batch(b=2, h=128, w=160)
    body = SwinTransformer(_port_swin(W12_SWIN), torch.float32)
    got, want = _run_backbone(JSwin(W12_SWIN, dtype=jnp.float32), body, pixels, mask)
    _check_levels(got, want, SWIN_TOL, "window 12")
    shifted = [layer.blocks[1]._tables._cache for layer in body.layers]
    padded = [next(iter(c))[1:3] for c in shifted]
    assert padded == [(36, 48), (24, 24), (12, 12), (12, 12)]
    assert body.layers[0].blocks[1].shift == 6


@pytest.mark.parametrize("name", ["resnet50", "resnet101"])
def test_resnet_matches_jax(name):
    """ResNet with frozen BN (seeded BN statistics, positive variances) on
    a padded 64x96 image: layer2..4's features (512/1024/2048 channels) and
    their nearest-resized masks against JAX's."""
    from ziragroundingdino_tpu.models.resnet import ResNet as JResNet

    depths = pc.RESNET_DEPTHS[name]
    pixels, mask = tiny_image_batch(b=2)
    body = ResNetBackbone(depths, (1, 2, 3), torch.float32)
    got, want = _run_backbone(JResNet(depths=depths, out_indices=(1, 2, 3), dtype=jnp.float32),
                              body, pixels, mask)
    assert [f.shape[-1] for f, _ in got] == [512, 1024, 2048] == list(body.out_channels)
    _check_levels(got, want, MODEL_TOL, name)
    # the frozen BN's four tensors are parameters, as JAX's
    names = {n for n, _ in body.named_parameters()}
    assert {"body.bn1.running_mean", "body.bn1.running_var",
            "body.layer1.0.downsample.1.running_var"} <= names


@pytest.mark.parametrize("hw", [(7, 9), (100, 152)])
def test_learned_positions_match_jax(hw):
    """The learned tables against JAX's `position_embedding_learned`, also
    past the 50 rows (the stride-8 level at 800x1216), where both clamp."""
    from ziragroundingdino_tpu.models.position_encoding import position_embedding_learned

    rng = np.random.RandomState(0)
    row, col = rng.rand(2, 50, 16).astype(np.float32)
    mask = np.ones((2,) + hw, bool)
    want = position_embedding_learned(jnp.asarray(mask), jnp.asarray(row), jnp.asarray(col))
    sd = jax_params_to_state_dict({"pos_row_embed": row, "pos_col_embed": col})
    pos = PositionEmbeddingLearned(16)
    pos.load_state_dict({k[len("backbone.1."):]: v for k, v in sd.items()}, strict=True)
    got = pos(torch.from_numpy(mask))
    assert got.shape == (2,) + hw + (32,)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


# the whole model at tiny_config: each switch, by name
MODEL_CASES = {
    "resnet50": dict(backbone="resnet50"),
    "learned": dict(position_embedding="learned"),
    "resnet50_v3": dict(backbone="resnet50", position_embedding="v3"),
    "swin_window12": dict(swin_config=W12_SWIN),
    "no_text_enhancer": dict(use_text_enhancer=False),
    "no_fusion_layer": dict(use_fusion_layer=False),
    "no_text_cross_attention": dict(use_text_cross_attention=False),
    "no_embed_init_tgt": dict(embed_init_tgt=False),
    "no_sub_sentence": dict(sub_sentence_present=False),
    "shared_enc_class_head": dict(use_cls_linear=True, two_stage_class_embed_share=True),
}
# what each switch takes out of the model's keys (none where it adds or
# replaces a part)
REMOVED = {
    "no_text_enhancer": "transformer.encoder.text_layers.",
    "no_fusion_layer": "transformer.encoder.fusion_layers.",
    "no_text_cross_attention": ".ca_text.",
    "no_embed_init_tgt": "transformer.tgt_embed.",
    "shared_enc_class_head": "transformer.enc_out_class_embed.",
}


@pytest.fixture(scope="module")
def all_parts_keys():
    """The state-dict keys of the tiny ZiRa model with `use_cls_linear`:
    every part that a switch can remove is there."""
    cfg = port_config(tiny_config(use_cls_linear=True))
    with torch.device("meta"):
        return set(GroundingDINO(cfg).state_dict())


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_switch_matches_jax(case, all_parts_keys):
    """The port's state-dict keys are the bridge's for the JAX model's
    parameters (a switched-off part has none); the top-k indices are JAX's;
    `pred_logits`, `pred_boxes` and `encoded_text` at MODEL_TOL."""
    tp = TinyPair(**MODEL_CASES[case])
    keys = set(tp.port.state_dict())
    assert keys == set(jax_params_to_state_dict(tp.params))
    if case in REMOVED:
        assert not any(REMOVED[case] in k for k in keys)
        assert any(REMOVED[case] in k for k in all_parts_keys)
    fwd = jax.jit(lambda p, px, m, t: tp.jmodel.apply(
        {"params": p}, px, m, t, capture_intermediates=True))
    jout, inter = fwd(tp.params, jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text)
    with torch.inference_mode():
        pout = tp.port(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask),
                       torch_text(tp.tb))
    enc_logits = inter["intermediates"]["class_embed"]["__call__"][0]
    _, jidx = jax.lax.top_k(jnp.max(enc_logits, axis=-1), tp.cfg.num_queries)
    np.testing.assert_array_equal(pout["topk_idx"].numpy(), np.asarray(jidx))
    for k in ("pred_logits", "pred_boxes", "encoded_text"):
        assert_close(pout[k], jout[k], MODEL_TOL, what=f"{case} {k}")

