"""The presets the port builds beside the ZiRa headline model, served: the
vanilla `groundingdino`, `repgroundingdino`,
`dualzerorepmultilayerbranchgroundingdino`, `repconvbngroundingdino` and
the ZiRa model's LoRA language branch (`zira_lan_adapter="lora"`).

Each preset's tiny JAX model and the port get the same seeded parameters
(and BatchNorm statistics) through the weight bridge; the forwards are held
in the order of `tests/test_torch_model.py`: the encoder memory (1e-4), the
selected queries (equal), then `pred_logits` / `pred_boxes` (1e-4). Then
every preset's fields against the JAX package's, `load_model`'s non-strict merge
against the JAX package's (a ZiRa model from a checkpoint without its ZiRa
keys, unknown and mis-shaped keys reported), the port's demo end to end on
the CPU, and `annotate` at the image's edges.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.torch_common import TinyPair, assert_close, port_config, torch_text
from ziragroundingdino_torch import config as pconfig
from ziragroundingdino_torch.data.synthetic import write_ppm, write_vocab
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.utils import inference as pinf

ATOL = 1e-4

# case: (preset, overrides); the LoRA branch is the ZiRa model's option
PRESETS = {
    "groundingdino": ("groundingdino", {}),
    "repgroundingdino": ("repgroundingdino", {}),
    "multilayer": ("dualzerorepmultilayerbranchgroundingdino", {}),
    "repconvbn": ("repconvbngroundingdino", {}),
    "lora": ("dualzerorepbranchgroundingdino", {"zira_lan_adapter": "lora"}),
}
# the switches that tell the presets apart (`config.py:229-250` of the JAX package)
SWITCHES = ("modelname", "use_cet", "use_project_adapter", "use_zero_inter_loss",
            "use_zero_inter_loss_for_conv")
# the tiny config's fields, as overrides of a preset
TINY_FIELDS = ("hidden_dim", "nheads", "dim_feedforward", "enc_layers", "dec_layers",
               "num_queries", "num_feature_levels", "max_text_len", "max_categories",
               "compute_dtype", "swin_config", "bert_config", "fusion_droppath")


def preset_overrides(case: str) -> dict:
    """The tiny config's overrides that make `case`'s preset."""
    from ziragroundingdino_tpu.config import MODEL_PRESETS

    preset, extra = PRESETS[case]
    cfg = MODEL_PRESETS[preset]
    return dict({k: getattr(cfg, k) for k in SWITCHES}, **extra)


def tiny_pair(case: str, seed: int = 0) -> TinyPair:
    return TinyPair(seed=seed, **preset_overrides(case))


@pytest.fixture(scope="module", params=sorted(PRESETS))
def served(request):
    """(case, pair, JAX output and intermediates, port output, the port's
    encoder output) of one preset."""
    tp = tiny_pair(request.param)
    fwd = jax.jit(lambda v, px, m, t: tp.jmodel.apply(v, px, m, t, capture_intermediates=True))
    jout, inter = fwd(tp.variables(), jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text)
    captured = {}
    hook = tp.port.transformer.encoder.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("encoder", out))
    try:
        with torch.inference_mode():
            pout = tp.port(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask),
                           torch_text(tp.tb))
    finally:
        hook.remove()
    return request.param, tp, jout, inter["intermediates"], pout, captured["encoder"]


def test_preset_encoder_memory(served):
    case, _, _, inter, _, (memory, memory_text, _) = served
    jmem, jtext, _ = inter["transformer"]["encoder"]["__call__"][0]
    assert_close(memory, jmem, ATOL, what=f"{case}: image memory")
    assert_close(memory_text, jtext, ATOL, what=f"{case}: text memory")


def test_preset_topk_indices(served):
    case, tp, _, inter, pout, _ = served
    enc_logits = inter["class_embed"]["__call__"][0]
    _, jidx = jax.lax.top_k(jnp.max(enc_logits, axis=-1), tp.cfg.num_queries)
    np.testing.assert_array_equal(pout["topk_idx"].numpy(), np.asarray(jidx), err_msg=case)


def test_preset_detections(served):
    case, tp, jout, _, pout, _ = served
    q, t = tp.cfg.num_queries, tp.cfg.max_text_len
    assert pout["pred_logits"].shape == (2, q, t) and pout["pred_boxes"].shape == (2, q, 4)
    assert_close(pout["pred_logits"], jout["pred_logits"], ATOL, what=f"{case}: pred_logits")
    assert_close(pout["pred_boxes"], jout["pred_boxes"], ATOL, what=f"{case}: pred_boxes")
    assert_close(pout["encoded_text"], jout["encoded_text"], ATOL, what=f"{case}: encoded_text")
    # which branches the preset builds: none in the vanilla model, no
    # language branch in the rep variants
    names = {n.split(".")[0] for n, _ in tp.port.named_parameters() if "adapter" in n}
    want = {"groundingdino": set(), "repgroundingdino": {"input_proj_conv_adapter"},
            "repconvbn": {"input_proj_conv_adapter"},
            "multilayer": {"rep_language_adapter", "input_proj_conv_adapter"},
            "lora": {"rep_linear_adapter", "input_proj_conv_adapter"}}[case]
    assert names == want


def _field_gaps(port, ref):
    """{field: (port's, JAX's)} of the port dataclass's fields that differ;
    every field of the port's must be one of JAX's."""
    names = [f.name for f in dataclasses.fields(port)]
    assert set(names) <= {f.name for f in dataclasses.fields(ref)}
    return {k: (getattr(port, k), getattr(ref, k)) for k in names
            if k not in ("swin_config", "bert_config") and getattr(port, k) != getattr(ref, k)}


@pytest.mark.parametrize("name", sorted(pconfig.MODEL_PRESETS))
def test_port_presets_match_jax_presets(name):
    """The port has the JAX package's 12 presets, and each equals JAX's
    field for field (the Swin and BERT configs too): every field of the
    port's configs is one of JAX's, with its value. `build_model` builds
    the preset."""
    from ziragroundingdino_tpu.config import MODEL_PRESETS as JAX_PRESETS

    assert set(pconfig.MODEL_PRESETS) == set(JAX_PRESETS)
    port, ref = pconfig.MODEL_PRESETS[name], JAX_PRESETS[name]
    assert not _field_gaps(port, ref)
    assert not _field_gaps(port.swin, ref.swin)
    assert not _field_gaps(port.bert, ref.bert)
    # the PET and CAT switches are among the compared fields
    assert {"freeze_all", "use_adapter", "use_prompt", "use_cls_linear", "cet_type",
            "num_experts"} <= {f.name for f in dataclasses.fields(port)}
    model = build_model(name, device="cpu")  # full width, f32 parameters
    assert model.cfg == port and len(model.transformer.decoder.layers) == 6


def _zira_keys(sd):
    return sorted(k for k in sd if "adapter" in k)


@pytest.fixture(scope="module")
def vanilla_checkpoint(tmp_path_factory):
    """A tiny ZiRa model's reference-format checkpoint saved without its
    ZiRa keys (the released vanilla checkpoint's shape), a vocab, and the
    pair it came from."""
    tp = TinyPair(seed=0)  # the ZiRa headline model, 25 ZiRa tensors
    sd = dict(tp.port.state_dict())
    dropped = _zira_keys(sd)
    root = tmp_path_factory.mktemp("ckpt")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items() if k not in dropped}},
               root / "vanilla.pth")
    write_vocab(str(root / "vocab.txt"), tiny_tokenizer().vocab)
    return tp, root, dropped


def test_load_model_merges_a_vanilla_checkpoint_into_zira(vanilla_checkpoint, monkeypatch):
    """Both packages load the checkpoint without its 25 ZiRa keys into the
    ZiRa preset; the port reports exactly those keys as missing and nothing
    unexpected, keeps them at their init (freeze zeros, branch 1e-8, scaling
    0.1), and its forward matches JAX's `load_model` at 1e-4. (JAX's
    `load_model` builds its parameter skeleton with `model.init`; the test
    runs that init under `jax.jit`, which gives the same values sooner.)"""
    from ziragroundingdino_tpu.models.groundingdino import GroundingDINO
    from ziragroundingdino_tpu.utils import inference as jinf

    class JitInit(GroundingDINO):
        def init(self, *args):
            return jax.jit(super().init)(*args)

    monkeypatch.setattr(jinf, "GroundingDINO", JitInit)
    tp, root, dropped = vanilla_checkpoint
    assert len(dropped) == 25
    jov = {k: getattr(tp.cfg, k) for k in TINY_FIELDS}
    pov = {k: getattr(port_config(tp.cfg), k) for k in TINY_FIELDS}
    ckpt, vocab = str(root / "vanilla.pth"), str(root / "vocab.txt")
    jlm = jinf.load_model(ckpt, vocab, preset="dualzerorepbranchgroundingdino", **jov)
    plm = pinf.load_model(ckpt, vocab, preset="dualzerorepbranchgroundingdino", device="cpu",
                          **pov)
    assert sorted(plm.missing) == dropped and not plm.unexpected and not plm.mismatched
    sd = plm.model.state_dict()
    assert torch.all(sd["rep_linear_adapter.freeze_linear.weight"] == 0)
    assert torch.all(sd["input_proj_conv_adapter.3.weight"] == 1e-8)
    assert torch.all(sd["input_proj_conv_adapter.0.scaling"] == 0.1)
    for k, v in sd.items():
        if k not in dropped:
            assert torch.equal(v, tp.port.state_dict()[k]), k

    jout, inter = jax.jit(lambda p, px, m, t: jlm.model.apply(p, px, m, t,
                                                              capture_intermediates=True))(
        jlm.params, jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text)
    enc_logits = inter["intermediates"]["class_embed"]["__call__"][0]
    _, jidx = jax.lax.top_k(jnp.max(enc_logits, axis=-1), tp.cfg.num_queries)
    with torch.inference_mode():
        pout = plm.model(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask),
                         torch_text(tp.tb))
    np.testing.assert_array_equal(pout["topk_idx"].numpy(), np.asarray(jidx))
    for k in ("pred_logits", "pred_boxes", "encoded_text"):
        assert_close(pout[k], jout[k], ATOL, what=k)


def test_load_model_reports_unknown_and_mismatched_keys(vanilla_checkpoint, tmp_path):
    """A renamed key comes back in `unexpected` (and the key it should have
    been in `missing`), a tensor of the wrong shape in `mismatched`; both
    keep the model's init, and the vanilla preset takes the same checkpoint
    with nothing missing."""
    tp, root, _ = vanilla_checkpoint
    sd = torch.load(root / "vanilla.pth", weights_only=True)["model"]
    sd["module.feat_map.weights"] = sd.pop("module.feat_map.weight")
    sd["module.transformer.level_embed"] = torch.zeros(3, 5)
    torch.save({"model": sd}, tmp_path / "broken.pth")
    pov = {k: getattr(port_config(tp.cfg), k) for k in TINY_FIELDS}
    vocab = str(root / "vocab.txt")
    lm = pinf.load_model(str(tmp_path / "broken.pth"), vocab, device="cpu", **pov)
    assert lm.cfg.modelname == "groundingdino"  # the default preset, as in the JAX package
    assert lm.unexpected == ["feat_map.weights"]
    assert lm.missing == ["feat_map.weight"]
    assert lm.mismatched == ["transformer.level_embed (shape (4, 64) vs (3, 5))"]
    fresh = build_model(port_config(tp.cfg).replace(
        **{k: getattr(pconfig.MODEL_PRESETS["groundingdino"], k) for k in SWITCHES}),
        device="cpu")
    for k in ("feat_map.weight", "transformer.level_embed"):
        assert torch.equal(lm.model.state_dict()[k], fresh.state_dict()[k]), k
    lm = pinf.load_model(str(root / "vanilla.pth"), vocab, device="cpu", **pov)
    assert not (lm.missing or lm.unexpected or lm.mismatched)


def test_demo_end_to_end_on_the_cpu(vanilla_checkpoint, tmp_path):
    """`scripts/inference_on_a_image.main` on a tiny vanilla checkpoint and
    a PPM on disk: the JSON it writes holds `predict`'s boxes, scores and
    phrases, and it writes the annotated image as PPM."""
    from ziragroundingdino_torch.data.transforms import load_image, read_image
    from ziragroundingdino_torch.scripts import inference_on_a_image

    tp, root, _ = vanilla_checkpoint
    cfg = port_config(tp.cfg)
    image = np.random.RandomState(3).randint(0, 256, (48, 72, 3)).astype(np.uint8)
    write_ppm(str(tmp_path / "image.ppm"), image)
    data = {"test_short_side": 64, "max_size": 96, "shape_buckets": [[64, 96]]}
    model = {k: getattr(cfg, k) for k in TINY_FIELDS if k not in ("swin_config", "bert_config")}
    model["swin_config"] = dataclasses.asdict(cfg.swin_config)
    model["bert_config"] = dataclasses.asdict(cfg.bert_config)
    (tmp_path / "ov.json").write_text(json.dumps({"model": model, "data": data}))
    out = tmp_path / "out"
    caption = "cat . dog ."
    pred = inference_on_a_image.main([
        "-p", str(root / "vanilla.pth"), "--vocab", str(root / "vocab.txt"),
        "-i", str(tmp_path / "image.ppm"), "-t", caption, "-o", str(out),
        "--box-threshold", "0.0", "--config-overrides", str(tmp_path / "ov.json"),
        "--device", "cpu"])

    lm = pinf.load_model(str(root / "vanilla.pth"), str(root / "vocab.txt"), device="cpu",
                         **{k: getattr(cfg, k) for k in TINY_FIELDS})
    dcfg = pconfig.DataConfig(test_short_side=64, max_size=96, shape_buckets=((64, 96),))
    _, (pixels, mask), size = load_image(str(tmp_path / "image.ppm"), dcfg)
    assert size == (64, 96)
    boxes, scores, phrases = pinf.predict(lm, pixels, mask, caption, box_threshold=0.0)
    saved = json.loads((out / "pred.json").read_text())
    assert saved == pred and len(saved["boxes"]) == tp.cfg.num_queries
    np.testing.assert_array_equal(np.asarray(saved["boxes"], np.float32), boxes)
    np.testing.assert_array_equal(np.asarray(saved["scores"], np.float32), scores)
    assert saved["phrases"] == phrases
    drawn = read_image(str(out / "pred.ppm"))
    assert drawn.shape == image.shape and (drawn != image).any()


# cxcywh boxes whose corners land on whole pixels of a 40 x 60 image: inside,
# over each edge and corner, and larger than the image
EDGE_BOXES = np.array([(0.25, 0.25, 0.5, 0.5), (0.0, 0.0, 0.5, 0.5), (1.0, 1.0, 0.5, 0.5),
                       (0.5, 0.5, 1.0, 1.0), (0.5, 0.5, 1.5, 1.5), (0.9, 0.1, 0.3, 0.3),
                       (0.0, 0.5, 0.4, 0.2)])


@pytest.mark.parametrize("with_pil", [False, True])
def test_annotate_draws_inside_the_image(with_pil, monkeypatch):
    """Without PIL, `annotate` draws each box's 2-pixel outline as PIL's
    `rectangle(width=2)` draws it, clipped to the image, and nothing else;
    with PIL it also writes the labels, over the same outlines."""
    from PIL import Image, ImageDraw

    h, w = 40, 60
    image = np.random.RandomState(0).randint(0, 200, (h, w, 3)).astype(np.uint8)
    if not with_pil:
        monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    got = pinf.annotate(image, EDGE_BOXES, np.full(len(EDGE_BOXES), 0.5),
                        ["cat"] * len(EDGE_BOXES))
    assert got.shape == image.shape and got.dtype == np.uint8
    monkeypatch.undo()
    ref = Image.fromarray(image.copy())
    draw = ImageDraw.Draw(ref)
    for cx, cy, bw, bh in EDGE_BOXES * [w, h, w, h]:
        draw.rectangle([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], outline=(255, 0, 0),
                       width=2)
    ref = np.asarray(ref)
    outline = (ref != image).any(-1)
    assert outline[0].any() and outline[-1].any() and outline[:, 0].any() and outline[:, -1].any()
    assert (got[outline] == (255, 0, 0)).all()
    if with_pil:
        assert (got != ref).any()  # the labels
    else:
        np.testing.assert_array_equal(got, ref)
