"""MM-Grounding-DINO-L's layout (`benchmark/configs/mmgdino-l.json`) on the
CPU at tiny widths: Swin's four stages, stage 0 (stride 4) included through
its `norm0` and the 1x1 `input_proj.0`, and a fifth level, a 3x3 stride-2
conv on the last stage with its mask resized from the image's; Swin-L's
head size (32 in every stage: heads 1, 2, 4, 8 over widths 32-256) and
window 12.

The port is held to the benchmark's plain reference
(`benchmark/reference/model.py`, f32) on seeded weights, through
`GroundingDINO.forward` and through the `Predictor` (its logits, boxes and
detections), and to the JAX package's model. In f32 the port computes what
the reference computes, in the same order: their outputs agree to rounding
(`LOGIT_TOL`, `BOX_TOL`, the tolerances of
`benchmark/tests/test_bench_reference.py`). The same comparison with the port
in bf16 fails them by orders of magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.lib import program, weights
from benchmark.reference import data as rdata
from benchmark.reference import model as R
from benchmark.reference import text as rtext
from benchmark.tests.tiny import tiny_config
from tests.common import TINY_SWIN
from tests.torch_common import TinyPair, assert_close, torch_text
from ziragroundingdino_torch.config import DataConfig
from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer
from ziragroundingdino_torch.utils.predictor import Predictor

LOGIT_TOL, BOX_TOL = 1e-5, 1e-6  # f32 against f32, the same operations in the same order
JAX_TOL = 1e-4  # the port against JAX's XLA programs, as tests/test_torch_backbones.py
NAMES = ["person", "dog", "traffic light", "hair drier", "cat", "zebra", "boat"]
LEVELS = 5
SWIN = dict(embed_dim=32, num_heads=[1, 2, 4, 8], window_size=12)  # head size 32, as Swin-L's
BUCKETS = ((96, 128), (128, 96), (96, 160))


def layout(dtype: str = "float32") -> dict:
    """The configuration file at tiny widths, its layout kept."""
    conf = tiny_config("mmgdino-l")
    conf["swin"].update(SWIN)
    conf["model"]["compute_dtype"] = dtype
    return conf


@pytest.fixture(scope="module")
def pair():
    conf = layout()
    rc = R.RefConfig.from_file(conf)
    sd = weights.make_state_dict(R.state_shapes(rc), 2**31 + 20, torch.device("cpu"))
    ref = R.build(rc, "cpu")
    ref.load_state_dict(sd)
    port = program.build(conf, sd, torch.device("cpu"))
    return conf, sd, port, ref


def inputs(vocab, captions):
    tb = rtext.text_batch(vocab, captions, (16, 32, 64), 64, 8)
    text = {k: torch.from_numpy(v) for k, v in tb.items()}
    g = torch.Generator().manual_seed(2)
    px = torch.randint(0, 256, (len(captions), 100, 132, 3), generator=g, dtype=torch.uint8)
    mask = torch.zeros(len(captions), 100, 132, dtype=torch.bool)
    mask[0] = True
    mask[1:, :77, :101] = True  # padding that the conv level's mask must follow
    return px, mask, text


def forwards(port, ref):
    vocab = rtext.make_vocab([w for n in NAMES for w in n.split()])
    px, mask, text = inputs(vocab, [rtext.caption(NAMES), rtext.caption(NAMES[2:4])])
    with torch.no_grad():
        return port(px, mask, text), ref(px, mask, text)


def test_five_levels_as_configured(pair):
    conf, sd, port, ref = pair
    assert len(port.input_proj) == LEVELS and "backbone.0.norm0.weight" in sd
    # OIHW: stage 0's channels through a 1x1, the last stage's through a 3x3
    assert tuple(port.input_proj[0][0].weight.shape[1:]) == (SWIN["embed_dim"], 1, 1)
    assert tuple(port.input_proj[4][0].weight.shape[1:]) == (8 * SWIN["embed_dim"], 3, 3)
    _, b = forwards(port, ref)
    assert [tuple(int(x) for x in s) for s in b["shapes"]] == [(25, 33), (13, 17), (7, 9),
                                                               (4, 5), (2, 3)]


def test_forward_matches_the_reference(pair):
    conf, sd, port, ref = pair
    a, b = forwards(port, ref)
    assert torch.equal(a["topk_idx"], b["topk_idx"])
    torch.testing.assert_close(a["pred_logits"], b["pred_logits"], rtol=0, atol=LOGIT_TOL)
    torch.testing.assert_close(a["pred_boxes"], b["pred_boxes"], rtol=0, atol=BOX_TOL)


def test_bf16_port_fails_the_f32_tolerance(pair):
    """The tolerance can see a lower precision: the same weights and
    inputs with the port in bf16 miss it."""
    conf, sd, port, ref = pair
    low = program.build(layout("bfloat16"), sd, torch.device("cpu"))
    a, b = forwards(low, ref)
    # follow the bf16 port's own selection, so the decoder's inputs are alike
    vocab = rtext.make_vocab([w for n in NAMES for w in n.split()])
    px, mask, text = inputs(vocab, [rtext.caption(NAMES), rtext.caption(NAMES[2:4])])
    with torch.no_grad():
        b = ref(px, mask, text, topk_idx=a["topk_idx"])
    logit = float((a["pred_logits"].float() - b["pred_logits"]).abs().max())
    box = float((a["pred_boxes"].float() - b["pred_boxes"]).abs().max())
    assert logit > 100 * LOGIT_TOL and box > 100 * BOX_TOL, (logit, box)


def test_predictor_matches_the_reference(pair):
    """The Predictor's detections (per-category scores, labels, boxes in
    original pixels) against the reference's resize, padding, text batch,
    forward and post-processing of the same request."""
    conf, sd, port, ref = pair
    dcfg = DataConfig(test_short_side=96, max_size=160, shape_buckets=BUCKETS)
    vocab = rtext.make_vocab([w for n in NAMES for w in n.split()])
    k = 50
    pred = Predictor(port, WordPieceTokenizer(vocab), dcfg, select_k=k,
                     text_len_buckets=(32, 64), batch_buckets=(1, 2), category_buckets=(4, 8))
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (150, 200, 3), dtype=np.uint8),
              rng.integers(0, 256, (160, 120, 3), dtype=np.uint8)]
    labels = [NAMES[:3], NAMES[3:]]
    got = pred(images, labels, score_threshold=-1.0)

    imgs = [rdata.eval_resize(im, dcfg.test_short_side, dcfg.max_size) for im in images]
    # a landscape and a portrait bucket: padded to the larger height and width
    picked = [rdata.pick_bucket(im.shape[0], im.shape[1], BUCKETS) for im in imgs]
    assert picked == [(96, 128), (128, 96)]
    px, mask = rdata.pad_batch(imgs, (128, 128))
    tb = rtext.text_batch(vocab, [rtext.caption(l) for l in labels], (32, 64), 64, 4)
    text = {key: torch.from_numpy(v) for key, v in tb.items()}
    with torch.no_grad():
        out = ref(torch.from_numpy(px), torch.from_numpy(mask), text)
        scores, labs, boxes = R.detections(
            R.per_category(out["pred_logits"], text["cate_to_token_mask"]), out["pred_boxes"],
            torch.tensor([im.shape[:2] for im in images]), k)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g["scores"], scores[i].numpy(), rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(g["labels"], labs[i].numpy())
        # pixels of the original image: a box fraction's rounding times ~200
        np.testing.assert_allclose(g["boxes"], boxes[i].numpy(), rtol=0, atol=250 * BOX_TOL)


def test_port_matches_jax_at_five_levels():
    """The JAX package's model at the same layout (tiny widths, one block a
    stage) and the port with its parameters."""
    swin = TINY_SWIN.__class__(**dict(vars(TINY_SWIN), embed_dim=SWIN["embed_dim"],
                                      num_heads=tuple(SWIN["num_heads"]),
                                      window_size=SWIN["window_size"],
                                      out_indices=(0, 1, 2, 3)))
    tp = TinyPair(seed=4, swin_config=swin, num_feature_levels=LEVELS,
                  return_interm_indices=(0, 1, 2, 3))
    assert len(tp.port.input_proj) == LEVELS
    jout = jax.jit(tp.jmodel.apply)({"params": tp.params}, jnp.asarray(tp.pixels),
                                    jnp.asarray(tp.mask), tp.text)
    with torch.inference_mode():
        pout = tp.port(torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask),
                       torch_text(tp.tb))
    for key in ("pred_logits", "pred_boxes", "encoded_text"):
        assert_close(pout[key], jout[key], JAX_TOL, what=key)
