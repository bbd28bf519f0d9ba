"""The port's serving `Predictor` against the JAX package's, f32 on the CPU.

One 3-image request at `tiny_config` (batch bucket 4, a wide and a tall
image, so the batch takes the larger of two image buckets,
a caption per image) through both predictors with `TinyPair`'s weights:
boxes and scores at 1e-4, labels and label names equal. One JAX compile,
shared by the module's fixture. Then the port's own routing (cache keys,
oversized requests, boxes inside the original frame) and the forward's
capture-safety: once warm, it makes no tensor from host data. Last, a
request that mixes a landscape and a portrait image, held to the JAX
Predictor on the same padded canvas (a second JAX compile).
"""

import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.torch_common import assert_close, tiny_pair  # noqa: F401 (fixture)
from ziragroundingdino_torch import config as pc
from ziragroundingdino_torch.utils.predictor import Predictor

ATOL = 1e-4  # the whole-model parity of tests/test_torch_model.py
BUCKETS = dict(select_k=10, text_len_buckets=(16, 32), batch_buckets=(1, 2, 4),
               category_buckets=(2, 8))
SHAPE_BUCKETS = ((64, 96), (96, 128))
REQUEST = [["cat", "dog"], ["zebra"], ["person", "fish", "car"]]


def _images():
    """A wide, a tall and a narrower image, each already at its eval size
    (short side 64, long side at most 96), so that no resize runs: the
    port's resize is held within one uint8 level of the JAX package's in
    tests/test_torch_data_eval.py, and here the routing is the point."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, shape, dtype=np.uint8)
            for shape in ((64, 96, 3), (96, 64, 3), (64, 80, 3))]


def _port_predictor(tiny_pair):
    dcfg = pc.DataConfig(test_short_side=64, max_size=96, shape_buckets=SHAPE_BUCKETS)
    return Predictor(tiny_pair.port, tiny_tokenizer(), dcfg, **BUCKETS)


@pytest.fixture(scope="module")
def jax_results(tiny_pair):
    from ziragroundingdino_tpu.config import DataConfig
    from ziragroundingdino_tpu.utils.predictor import Predictor as JaxPredictor

    dcfg = DataConfig(test_short_side=64, max_size=96, shape_buckets=SHAPE_BUCKETS,
                      num_workers=0)
    p = JaxPredictor(tiny_pair.jmodel, tiny_pair.variables(), tiny_tokenizer(), dcfg, **BUCKETS)
    out = p(_images(), REQUEST, score_threshold=0.0)
    assert len(p._compiled) == 1
    return out


def test_predictor_matches_jax(tiny_pair, jax_results):
    p = _port_predictor(tiny_pair)
    got = p(_images(), REQUEST, score_threshold=0.0)
    assert list(p._compiled) == [(4, (96, 128), 16, 8)]
    assert len(got) == len(jax_results) == 3
    for i, (g, w) in enumerate(zip(got, jax_results)):
        assert len(g["scores"]) == len(w["scores"]) == BUCKETS["select_k"]
        assert_close(g["scores"], w["scores"], ATOL, what=f"scores {i}")
        assert_close(g["boxes"], w["boxes"], ATOL, what=f"boxes {i}")
        np.testing.assert_array_equal(g["labels"], np.asarray(w["labels"]))
        assert g["label_names"] == w["label_names"]


def test_predictor_cache_keys_and_splits(tiny_pair):
    p = _port_predictor(tiny_pair)
    img = _images()[0]
    p([img], [["cat", "dog"]])
    assert list(p._compiled) == [(1, (64, 96), 16, 2)]
    p([img], [["dog", "cat"]])  # the same key: a cache hit
    assert len(p._compiled) == 1
    p([img, img], [["cat"], ["dog"]])  # a new batch size: one key more
    assert list(p._compiled)[1:] == [(2, (64, 96), 16, 2)]
    out = p([img] * 5, [["cat"]] * 5, score_threshold=0.0)  # 5 > 4: calls of 4 and 1
    assert len(out) == 5 and len(p._compiled) == 3
    assert (4, (64, 96), 16, 2) in p._compiled
    for r in out:  # batch 4 and batch 1: f32 sums in another order
        np.testing.assert_allclose(r["scores"], out[0]["scores"], atol=ATOL)


def test_predictor_boxes_inside_the_original_frame(tiny_pair):
    p = _port_predictor(tiny_pair)
    images = _images()
    out = p(images, REQUEST, score_threshold=0.0)
    for img, r in zip(images, out):
        h, w = img.shape[:2]
        assert r["boxes"].shape == (BUCKETS["select_k"], 4)
        assert np.all(r["boxes"] >= 0.0)
        assert np.all(r["boxes"][:, 0::2] <= w) and np.all(r["boxes"][:, 1::2] <= h)
        assert np.all(r["boxes"][:, 2:] >= r["boxes"][:, :2])
        assert np.all(np.diff(r["scores"]) <= 0.0)


def test_warm_forward_makes_no_tensor_from_host_data(tiny_pair, monkeypatch):
    """The three places that made a host->device copy in every forward (the
    uint8 path's mean/std, the deformable layers' (w, h) table, the -inf of
    `recover_to_cls_logits`) read cached device constants or a Python
    scalar: a warm forward and post-processing, with every way to make a
    tensor from host data disabled, gives the same detections."""
    p = _port_predictor(tiny_pair)
    images = _images()
    want = p(images, REQUEST, score_threshold=0.0)
    prog = next(iter(p._compiled.values()))

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from host data inside the forward")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    with torch.inference_mode():
        scores, labels, boxes = p._run(prog)
    monkeypatch.undo()
    for i, w in enumerate(want):
        np.testing.assert_array_equal(scores[i].numpy()[:len(w["scores"])], w["scores"])
        np.testing.assert_array_equal(boxes[i].numpy(), w["boxes"])
        np.testing.assert_array_equal(labels[i].numpy(), w["labels"])


def test_request_mixing_orientations_serves(tiny_pair):
    """A landscape and a portrait image whose buckets are transposes of
    each other: the request pads to the largest height and the largest
    width of the two buckets, as `data/loader.py::collate` pads a batch
    (the bucket of the larger area, either one, would not hold the other
    image), and answers both in their original frames. Held at 1e-4 to the
    JAX Predictor given that padded shape as its one bucket: both pad the
    same eval-size images onto the same 96x96 canvas."""
    from ziragroundingdino_tpu.config import DataConfig
    from ziragroundingdino_tpu.utils.predictor import Predictor as JaxPredictor

    request = [["cat", "dog"], ["zebra"]]
    dcfg = pc.DataConfig(test_short_side=64, max_size=96, shape_buckets=((64, 96), (96, 64)))
    p = Predictor(tiny_pair.port, tiny_tokenizer(), dcfg, **BUCKETS)
    images = _images()[:2]  # 64x96 and 96x64
    out = p(images, request, score_threshold=0.0)
    assert list(p._compiled) == [(2, (96, 96), 16, 2)]
    jdcfg = DataConfig(test_short_side=64, max_size=96, shape_buckets=((96, 96),),
                       num_workers=0)
    jp = JaxPredictor(tiny_pair.jmodel, tiny_pair.variables(), tiny_tokenizer(), jdcfg,
                      **BUCKETS)
    want = jp(images, request, score_threshold=0.0)
    for i, (img, r, w) in enumerate(zip(images, out, want)):
        h, wd = img.shape[:2]
        assert r["boxes"].shape == (BUCKETS["select_k"], 4)
        assert np.all(r["boxes"][:, 0::2] <= wd) and np.all(r["boxes"][:, 1::2] <= h)
        assert len(r["scores"]) == len(w["scores"])
        assert_close(r["scores"], w["scores"], ATOL, what=f"scores {i}")
        assert_close(r["boxes"], w["boxes"], ATOL, what=f"boxes {i}")
        np.testing.assert_array_equal(r["labels"], np.asarray(w["labels"]))
        assert r["label_names"] == w["label_names"]
