"""The spans inside the port on the CPU, at the tiny config, under a
`torch.profiler` (`utils/profiling.py::span`):

* a Predictor request is one `predictor.request` span with its six
  children (and `predictor.capture` on a key's first request), the model's
  layer spans inside `predictor.run`, and counts of real and padded pixels
  and tokens equal to the arithmetic from `eval_size` and the tokenizer;
* `predictor.run` has one child a part of the forward
  (`predictor.run.text`, `.backbone`, `.encoder`, `.decoder`), in order,
  within its time; with no profiler recording, no span and no part is kept;
* a remat train step is one `step` span with `step.forward`,
  `step.criterion`, `step.backward` and `step.optimizer` under its id, the
  encoder's layer spans in the forward and, recomputed, in the backward.
"""

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tests.common import tiny_config, tiny_tokenizer
from tests.torch_common import port_config
from ziragroundingdino_torch import config as pc
from ziragroundingdino_torch.data.transforms import eval_size, pick_bucket
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.text.tokenizer import tokenize_captions
from ziragroundingdino_torch.train import optim
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.utils import profiling
from ziragroundingdino_torch.utils.predictor import PARTS as PREDICTOR_PARTS
from ziragroundingdino_torch.utils.predictor import Predictor

REQUEST = ["predictor.resize", "predictor.pad", "predictor.tokenize", "predictor.stage",
           "predictor.run", "predictor.results"]
ENCODER = [f"encoder.{kind}.{i}" for i in range(2) for kind in ("fusion", "text", "deform")]
MODEL = (["model.text", "model.backbone"] + ENCODER + ["decoder.layer.0", "decoder.layer.1",
                                                       "model.heads"])
PARTS = [f"predictor.run.{part}" for part in PREDICTOR_PARTS]


def _traced(fn):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _children(recs, parent):
    """The names of `parent`'s children, in the order they opened."""
    return [r.name for r in sorted(recs, key=lambda r: r.seq) if r.parent == parent.seq]


def _under(recs, ancestor):
    """The records below `ancestor`, in the order they opened."""
    by_seq = {r.seq: r for r in recs}

    def below(r):
        while r.parent is not None:
            if r.parent == ancestor.seq:
                return True
            r = by_seq[r.parent]
        return False

    return [r for r in sorted(recs, key=lambda r: r.seq) if below(r)]


def _predictor():
    model = build_model(port_config(tiny_config()), device="cpu", dtype="float32", seed=0)
    dcfg = pc.DataConfig(test_short_side=64, max_size=96, shape_buckets=((64, 96), (96, 128)))
    p = Predictor(model.eval(), tiny_tokenizer(), dcfg, select_k=10, text_len_buckets=(16, 32),
                  batch_buckets=(1, 2, 4), category_buckets=(2, 8))
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, s, dtype=np.uint8) for s in ((48, 80, 3), (100, 60, 3),
                                                              (64, 64, 3))]
    classes = [["cat", "dog"], ["zebra"], ["person", "fish", "car"]]
    return p, images, classes


def test_predictor_request_spans_and_counts():
    p, images, classes = _predictor()
    dcfg, tok = p.dcfg, p.tokenizer
    sizes = [eval_size(im.shape[0], im.shape[1], dcfg) for im in images]
    buckets = [pick_bucket(h, w, dcfg.shape_buckets) for h, w in sizes]
    bucket = (max(b[0] for b in buckets), max(b[1] for b in buckets))
    captions = [".".join(c) + "." for c in classes]
    tokens = [int(tokenize_captions(tok, [c], max_text_len=32, max_categories=8,
                                    text_len_buckets=(16, 32)).text_token_mask.sum())
              for c in captions]
    text_len = 16 if max(tokens) <= 16 else 32
    for first in (True, False):
        _, recs = _traced(lambda: p(images, classes))
        (req,) = [r for r in recs if r.name == "predictor.request"]
        want = REQUEST[:3] + ["predictor.capture"] * first + REQUEST[3:]
        assert _children(recs, req) == want
        assert all(r.id == req.id and not r.error for r in recs)
        assert req.counts == {"images": 3, "batch": 4,
                              "pixels_real": sum(h * w for h, w in sizes),
                              "pixels_padded": 4 * bucket[0] * bucket[1],
                              "tokens_real": sum(tokens), "tokens_padded": 4 * text_len}
        (run,) = [r for r in recs if r.name == "predictor.run"]
        assert [r.name for r in _under(recs, run)] == MODEL + PARTS
    assert len(p._compiled) == 1


def test_predictor_run_parts():
    p, images, classes = _predictor()
    for _ in range(2):  # the key's first request, then a prepared one
        _, recs = _traced(lambda: p(images, classes))
        (run,) = [r for r in recs if r.name == "predictor.run"]
        parts = [r for r in sorted(recs, key=lambda r: r.seq) if r.parent == run.seq
                 and r.name.startswith("predictor.run.")]
        assert [r.name for r in parts] == PARTS
        assert all(r.id == run.id and r.device_ms is None and not r.error for r in parts)
        # one after another, inside the run
        bounds = [run.start_ns] + [t for r in parts for t in (r.start_ns, r.end_ns)] + \
            [run.end_ns]
        assert bounds == sorted(bounds)
        assert all(r.end_ns > r.start_ns for r in parts)
        assert sum(r.ms for r in parts) <= run.ms
    # no profiler recording: nothing is kept, and no part is left open
    profiling.clear_spans()
    p(images, classes)
    assert profiling.spans() == [] and profiling._PARTS is None


def test_train_step_spans_with_remat():
    from tests.test_torch_train import _torch_batch
    from tests.test_train_step import make_batch

    cfg = port_config(tiny_config(use_checkpoint=True, use_transformer_ckpt=True))
    model = build_model(cfg, device="cpu", dtype="float32", seed=3)
    optim.set_trainable(model, optim.ZIRA_TRAINABLE_PATTERNS)
    model.train()
    opt = optim.Optimizer(model, pc.OptimizerConfig(lr=1e-2), pc.ScheduleConfig())
    batch = _torch_batch(make_batch())
    metrics, recs = _traced(lambda: pstep.train_step(model, opt, batch))
    assert torch.isfinite(metrics["total_loss"])
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "step" and all(r.id == root.id for r in recs)
    assert _children(recs, root) == ["step.forward", "step.criterion", "step.backward",
                                     "step.optimizer"]
    phase = {r.name: r for r in recs if r.parent == root.seq}
    assert [r.name for r in _under(recs, phase["step.forward"])] == MODEL
    assert _under(recs, phase["step.criterion"]) == []
    # remat recomputes the fusion and deformable layers in the backward (the
    # text layers are not checkpointed); a recompute may stop once it has
    # what the backward needs, closing its span by that exception
    recomputed = sorted(r.name for r in _under(recs, phase["step.backward"]))
    assert recomputed == sorted(n for n in ENCODER if ".text." not in n)
    assert not any(r.error for r in recs if not r.name.startswith("encoder."))
    assert all(r.start_ns <= r.end_ns for r in recs)
