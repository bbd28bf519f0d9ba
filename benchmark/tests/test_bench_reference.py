"""The frozen reference against the port at the tiny configuration on the
CPU, in float32: the same state dict, the same inputs, the same outputs.
(On the card the port computes in bf16; the run's check measures how far.)"""

import numpy as np
import pytest
import torch

from benchmark.lib import program, traffic, weights
from benchmark.reference import data as rdata
from benchmark.reference import model as R
from benchmark.reference import precision
from benchmark.reference import text as rtext
from benchmark.reference import train as RT
from benchmark.tests.tiny import tiny_config

NAMES = ["person", "dog", "traffic light", "hair drier", "cat"]


@pytest.fixture(scope="module")
def pair():
    conf = tiny_config()
    conf["model"]["compute_dtype"] = "float32"
    rc = R.RefConfig.from_file(conf)
    sd = weights.make_state_dict(R.state_shapes(rc), 2**31 + 5, torch.device("cpu"))
    ref = R.build(rc, "cpu")
    ref.load_state_dict(sd)
    port = program.build(conf, sd, torch.device("cpu"))
    return conf, port, ref


def inputs(vocab, captions, buckets=(16, 32, 64)):
    tb = rtext.text_batch(vocab, captions, buckets, 64, 8)
    text = {k: torch.from_numpy(v) for k, v in tb.items()}
    g = torch.Generator().manual_seed(1)
    px = torch.randint(0, 256, (len(captions), 96, 128, 3), generator=g, dtype=torch.uint8)
    mask = torch.zeros(len(captions), 96, 128, dtype=torch.bool)
    mask[0] = True
    mask[1:, :80, :100] = True
    return px, mask, text


def test_state_dict_keys_are_the_ports(pair):
    conf, port, ref = pair
    assert set(port.state_dict()) == set(ref.state_dict())


def test_tokenizer_and_masks_match_the_port():
    from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer, tokenize_captions

    vocab = rtext.make_vocab([w for n in NAMES for w in n.split()])
    caps = [rtext.caption(NAMES), rtext.caption(NAMES[1:3]), "Dog. Hair-Drier?"]
    tb = tokenize_captions(WordPieceTokenizer(vocab), caps, max_text_len=64, max_categories=8,
                           text_len_buckets=(16, 32, 64))
    mine = rtext.text_batch(vocab, caps, (16, 32, 64), 64, 8)
    for k in mine:
        if k == "cate_to_token_mask":
            assert np.array_equal(tb.cate_to_token_mask, mine[k])
        else:
            assert np.array_equal(np.asarray(getattr(tb, k)).astype(np.int64),
                                  mine[k].astype(np.int64)), k


def test_resize_and_pad_match_the_port():
    from ziragroundingdino_torch.config import DataConfig
    from ziragroundingdino_torch.data.transforms import Sample, eval_transform, pad_to_bucket

    img = np.random.default_rng(0).integers(0, 256, (300, 417, 3), dtype=np.uint8)
    cfg = DataConfig()
    port = eval_transform(Sample(image=img, boxes=np.zeros((0, 4), np.float32),
                                 labels=np.zeros((0,), np.int64)), cfg).image
    mine = rdata.eval_resize(img)
    assert np.array_equal(port, mine)
    px, m = pad_to_bucket(port, (800, 1216))
    px2, m2 = rdata.pad_batch([mine], (800, 1216))
    assert np.array_equal(px, px2[0]) and np.array_equal(m, m2[0])


def test_eval_forward_matches(pair):
    conf, port, ref = pair
    vocab = rtext.make_vocab([w for n in NAMES for w in n.split()])
    px, mask, text = inputs(vocab, [rtext.caption(NAMES), rtext.caption(NAMES[:2])])
    with torch.no_grad():
        a = port(px, mask, text)
        b = ref(px, mask, text)
    assert torch.equal(a["topk_idx"], b["topk_idx"])
    torch.testing.assert_close(a["pred_logits"], b["pred_logits"], rtol=0, atol=1e-5)
    torch.testing.assert_close(a["pred_boxes"], b["pred_boxes"], rtol=0, atol=1e-6)
    # following a given selection reproduces the same outputs
    with torch.no_grad():
        c = ref(px, mask, text, topk_idx=a["topk_idx"].flip(1))
    assert not torch.equal(c["pred_logits"], b["pred_logits"])


def test_train_forward_with_dropout_matches(pair):
    conf, port, ref = pair
    vocab = rtext.make_vocab([w for n in NAMES for w in n.split()])
    px, mask, text = inputs(vocab, [rtext.caption(NAMES), rtext.caption(NAMES[:2])])
    port.train()
    ref.train()
    try:
        a = port(px, mask, text, train=True, generator=torch.Generator().manual_seed(9))
        b = ref(px, mask, text, train=True, gen=torch.Generator().manual_seed(9))
        c = ref(px, mask, text, train=True, gen=torch.Generator().manual_seed(10))
    finally:
        port.eval()
        ref.eval()
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-5)
    assert not torch.allclose(b["pred_logits"], c["pred_logits"])  # the masks matter
    torch.testing.assert_close(a["interm_outputs"]["pred_boxes"],
                               b["interm_outputs"]["pred_boxes"], rtol=0, atol=1e-6)
    torch.testing.assert_close(a["adapter_losses"]["loss_conv_adapter"],
                               b["loss_conv_adapter"], rtol=1e-6, atol=0)
    torch.testing.assert_close(a["adapter_losses"]["loss_linear_adapter"],
                               b["loss_linear_adapter"], rtol=1e-6, atol=0)


def test_post_processing_matches_the_port():
    from ziragroundingdino_torch.eval.postprocess import scale_to_original, top_k_detections
    from ziragroundingdino_torch.text.masks import recover_to_cls_logits

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 30, 64, generator=g)
    boxes = torch.rand(2, 30, 4, generator=g) * 0.5 + 0.25
    c2t = torch.zeros(2, 8, 16, dtype=torch.bool)
    c2t[0, 0, 1:3] = c2t[0, 1, 4] = c2t[1, 0, 1] = True
    orig = torch.tensor([[480, 640], [600, 800]])
    det = top_k_detections(recover_to_cls_logits(logits[..., :16], c2t), boxes, k=20)
    s, lab, box = R.detections(R.per_category(logits, c2t), boxes, orig, 20)
    assert torch.equal(det["scores"], s) and torch.equal(det["labels"], lab)
    assert torch.equal(scale_to_original(det["boxes_cxcywh"], orig), box)


def test_adamw_and_clip_match_the_ports_optimizer():
    from ziragroundingdino_torch.config import OptimizerConfig, ScheduleConfig
    from ziragroundingdino_torch.train.optim import Optimizer

    g = torch.Generator().manual_seed(4)
    model = torch.nn.Module()
    model.adapter_w = torch.nn.Parameter(torch.randn(5, 3, generator=g))
    model.freeze_adapter = torch.nn.Parameter(torch.randn(7, generator=g))
    mine = {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}
    opt = Optimizer(model, OptimizerConfig(lr=1e-2, grad_clip=0.1,
                                           lr_factors=(("freeze", 0.2),)),
                    ScheduleConfig(max_iter=1000, milestones_frac=(0.4,)))
    ref = RT.AdamW(mine, 1e-2, (0.9, 0.999), 1e-4, [("freeze", 0.2)])
    for step in range(3):
        grads = {n: torch.randn(p.shape, generator=g) for n, p in mine.items()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
            mine[n].grad = grads[n].clone()
        opt.step()
        RT.clip_([p.grad for p in mine.values()], 0.1)
        ref.step()
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), mine[n].detach(), rtol=0, atol=1e-6)


def test_control_rounds_only_the_bf16_operands():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(5))
    assert torch.equal(precision.operand(x, True), x)
    with precision.control():
        y = precision.operand(x, True)
        assert torch.equal(precision.operand(x, False), x)
    err = ((y - x).norm() / x.norm()).item()
    assert 0.01 < err < 0.1  # e4m3's 3 mantissa bits


def test_same_work_for_the_port_batch_and_the_reference_batch():
    """The train cell's batch as the loader makes it (the port's collate)
    and as the reference makes it are the same numbers."""
    from benchmark.lib.train import TrainRun
    from benchmark.tests.tiny import tiny_mix

    conf = tiny_config()
    mix = tiny_mix("train-b8")
    run = TrainRun(conf, mix, 2**31 + 9, torch.device("cpu"))
    from ziragroundingdino_torch.config import DataConfig

    run.vocab = rtext.make_vocab(traffic.vocab_words(mix))
    run.dcfg = DataConfig(shape_buckets=tuple(tuple(b) for b in mix["shape_buckets"]),
                          max_size=mix["max_size"], max_boxes=mix["max_boxes"])
    run.cycle = traffic.train_cycle(mix, run.seed, run.device)
    port = run.port_batch(run.cycle[0])
    px, mask, batch = run.reference_batch(run.cycle[0])
    torch.testing.assert_close(
        port["pixels"], rdata.normalize(px, mask, conf["model"].get(
            "pixel_mean", (123.675, 116.28, 103.53)), (58.395, 57.12, 57.375)),
        rtol=0, atol=0)
    assert torch.equal(port["mask"], mask)
    for k in ("input_ids", "text_token_mask", "position_ids", "text_self_attention_masks",
              "cate_to_token_mask", "gt_labels", "gt_valid"):
        assert torch.equal(port[k].long(), batch[k].long()), k
    torch.testing.assert_close(port["gt_boxes"], batch["gt_boxes"], rtol=0, atol=1e-7)
