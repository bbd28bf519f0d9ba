"""The port's data and eval host code against the JAX package's, on a
synthetic PPM dataset written from a seed:

* the resize (torch's antialiased bilinear) within one uint8 level of PIL's
  `BILINEAR`, which the JAX package uses; PPM decoding equal to PIL's;
* `CocoDataset` samples equal (pixels, boxes, labels, areas, crowds);
* `train_transform` / `eval_transform` / `collate` from the same
  `RandomState`: text and targets equal, pixels within one level before
  normalization; the `DataLoader` streams, with the fast-forward and the
  eval padding, likewise;
* `CocoMeanAP` (every summary number equal), `top_k_detections` and
  `scale_to_original` (1e-6), and an oracle detector through
  `inference_on_dataset` (AP 100).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.common import tiny_tokenizer
from ziragroundingdino_torch import config as pconfig
from ziragroundingdino_torch.data import coco as pcoco
from ziragroundingdino_torch.data import loader as ploader
from ziragroundingdino_torch.data import transforms as ptf
from ziragroundingdino_torch.data.synthetic import write_ppm
from ziragroundingdino_torch.eval import coco_map as pmap
from ziragroundingdino_torch.eval import evaluator as peval
from ziragroundingdino_torch.eval import postprocess as ppost
from ziragroundingdino_tpu import config as jconfig
from ziragroundingdino_tpu.data import coco as jcoco
from ziragroundingdino_tpu.data import loader as jloader
from ziragroundingdino_tpu.data import transforms as jtf
from ziragroundingdino_tpu.eval import coco_map as jmap
from ziragroundingdino_tpu.eval import postprocess as jpost

LEVEL = 1  # uint8 levels between the torch and the PIL resize
POST_TOL = 1e-6
SIZES = [(120, 160), (96, 128), (150, 110), (64, 200), (130, 130)]
DATA = dict(train_short_sides=(64, 96), max_size=160, test_short_side=96,
            shape_buckets=((96, 128), (128, 160), (160, 224)), max_boxes=10, num_workers=0)


def _configs(**kw):
    kw = dict(DATA, **kw)
    return pconfig.DataConfig(**kw), jconfig.DataConfig(**kw)


@pytest.mark.parametrize("src,dst", [((480, 640), (800, 1066)), ((1024, 1365), (800, 1066)),
                                     ((375, 500), (800, 1066)), ((600, 800), (480, 640)),
                                     ((96, 128), (64, 85))])
def test_resize_within_one_level_of_pil(src, dst):
    image = np.random.RandomState(sum(src)).randint(0, 256, src + (3,), dtype=np.uint8)
    got = ptf.resize_u8(image, *dst)
    want = np.asarray(Image.fromarray(image).resize(dst[::-1], Image.BILINEAR))
    assert got.shape == want.shape == dst + (3,) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= LEVEL


def test_read_image_matches_pil(tmp_path):
    image = np.random.RandomState(0).randint(0, 256, (7, 11, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "a.ppm"), image)
    # a header with a comment, as other writers emit
    (tmp_path / "b.ppm").write_bytes(b"P6\n# made by a test\n11 7\n255\n" + image.tobytes())
    Image.fromarray(image).save(tmp_path / "c.png")
    for name in ("a.ppm", "b.ppm", "c.png"):
        got = ptf.read_image(str(tmp_path / name))
        np.testing.assert_array_equal(got, image, err_msg=name)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(tmp_path / name).convert("RGB")), err_msg=name)


@pytest.fixture()
def dataset(tmp_path):
    """Five PPM images of different sizes, 0-3 boxes each over two
    categories (ids 1 and 7), one crowd annotation, the areas given."""
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        write_ppm(str(tmp_path / f"{i}.ppm"), rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        images.append({"id": 10 + i, "file_name": f"{i}.ppm", "height": h, "width": w})
        for _ in range(i % 4):
            bw, bh = rng.uniform(10, 50), rng.uniform(10, 50)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": 10 + i,
                         "category_id": int(rng.choice([1, 7])),
                         "bbox": [x, y, bw, bh], "area": float(bw * bh * 0.8), "iscrowd": 0})
    anns.append({"id": len(anns) + 1, "image_id": 11, "category_id": 7,
                 "bbox": [5.0, 5.0, 40.0, 30.0], "area": 1200.0, "iscrowd": 1})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1, "name": "cat"},
                                               {"id": 7, "name": "dog"}]}))
    return (pcoco.CocoDataset.from_json(str(path), str(tmp_path)),
            jcoco.CocoDataset.from_json(str(path), str(tmp_path)))


def _samples_equal(got, want, image_level=0):
    assert got.image.shape == want.image.shape
    assert np.abs(got.image.astype(int) - want.image.astype(int)).max() <= image_level
    for f in ("boxes", "labels", "crowd_boxes", "crowd_labels", "gt_areas"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert tuple(got.orig_size) == tuple(want.orig_size) and got.image_id == want.image_id


def test_coco_dataset_matches_jax(dataset):
    pds, jds = dataset
    assert pds.category_names == jds.category_names == ["cat", "dog"]
    assert pds.caption == jds.caption and len(pds) == len(jds) == 5
    for i in range(len(pds)):
        _samples_equal(pds.load_sample(i), jds.load_sample(i))
    assert len(pds.load_sample(1).crowd_boxes) == 1


def test_transforms_and_collate_match_jax(dataset):
    """Every sample under eight seeds of the train transform (flip, the
    crop branch, the multi-scale resize) and under the eval transform."""
    pds, jds = dataset
    pcfg, jcfg = _configs()
    tok = tiny_tokenizer()
    for seed in range(8):
        got = [ptf.train_transform(pds.load_sample(i), pcfg, np.random.RandomState(seed))
               for i in range(len(pds))]
        want = [jtf.train_transform(jds.load_sample(i), jcfg, np.random.RandomState(seed))
                for i in range(len(jds))]
        for g, w in zip(got, want):
            _samples_equal(g, w, LEVEL)
    got = [ptf.eval_transform(pds.load_sample(i), pcfg) for i in range(len(pds))]
    want = [jtf.eval_transform(jds.load_sample(i), jcfg) for i in range(len(jds))]
    for g, w in zip(got, want):
        _samples_equal(g, w, LEVEL)
    captions = ["cat.dog."] * len(got)
    for train in (True, False):
        _batches_equal(ploader.collate(got, captions, tok, pcfg, 32, 8, train=train),
                       jloader.collate(want, captions, tok, jcfg, 32, 8, train=train), pcfg)


def _batches_equal(got, want, cfg):
    assert got.keys() == want.keys()
    std = np.asarray(cfg.pixel_std, np.float32)
    for k in want:
        if k == "pixels":
            # within one level of the uint8 image, before normalization
            assert np.abs((got[k] - want[k]) * std).max() <= LEVEL + 1e-3
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _stream(loader_cls, ds, cfg, n, **kw):
    it = iter(loader_cls(ds, tiny_tokenizer(), cfg, batch_size=2, max_text_len=32,
                         max_categories=8, **kw))
    return [next(it) for _ in range(n)]


def test_loader_matches_jax_and_fast_forwards(dataset):
    """The train stream: the JAX package's batches (index and augmentation
    RNGs alike), the same with prefetch threads, and from `start_batch=2`
    the uninterrupted stream's batches 2 and 3."""
    pds, jds = dataset
    pcfg, jcfg = _configs()
    serial = _stream(ploader.DataLoader, pds, pcfg, 4, seed=7)
    for g, w in zip(serial, _stream(jloader.DataLoader, jds, jcfg, 4, seed=7)):
        _batches_equal(g, w, pcfg)
    for g, w in zip(serial, _stream(ploader.DataLoader, pds, pcfg, 4, seed=7, num_workers=3)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for g, w in zip(serial[2:], _stream(ploader.DataLoader, pds, pcfg, 2, seed=7, start_batch=2)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_eval_loader_matches_jax(dataset):
    """A single pass in dataset order; the last batch padded with copies of
    its last sample and `real_count` saying how many are real."""
    pds, jds = dataset
    pcfg, jcfg = _configs()
    got = list(ploader.DataLoader(pds, tiny_tokenizer(), pcfg, batch_size=2, train=False,
                                  max_text_len=32, max_categories=8))
    want = list(jloader.DataLoader(jds, tiny_tokenizer(), jcfg, batch_size=2, train=False,
                                   max_text_len=32, max_categories=8))
    assert len(got) == len(want) == 3 and int(got[-1]["real_count"]) == 1
    for g, w in zip(got, want):
        _batches_equal(g, w, pcfg)


def _detections(rng, n_images=6, n_classes=3):
    """Seeded ground truth and detections near it, with misses, false
    positives, crowds and annotation areas."""
    out = []
    for img in range(n_images):
        g = rng.uniform(0, 300, (5, 2))
        gt = np.concatenate([g, g + rng.uniform(5, 120, (5, 2))], 1).astype(np.float32)
        gl = rng.randint(0, n_classes, 5)
        det = np.concatenate([gt + rng.normal(0, 6, gt.shape),
                              rng.uniform(0, 400, (4, 4)).clip(0)], 0).astype(np.float32)
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        dl = np.concatenate([np.where(rng.rand(5) < 0.8, gl, rng.randint(0, n_classes, 5)),
                             rng.randint(0, n_classes, 4)])
        crowd = np.array([[0, 0, 60, 60]], np.float32) if img % 3 == 0 else np.zeros((0, 4))
        out.append(dict(image_id=img, boxes=det, scores=rng.rand(9), labels=dl, gt_boxes=gt,
                        gt_labels=gl, crowd_boxes=crowd,
                        crowd_labels=np.zeros(len(crowd), np.int64),
                        gt_areas=(gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) * 0.7))
    return out


def test_coco_map_matches_jax():
    pev, jev = pmap.CocoMeanAP(num_classes=3), jmap.CocoMeanAP(num_classes=3)
    for d in _detections(np.random.RandomState(1)):
        args = (d["image_id"], d["boxes"], d["scores"], d["labels"], d["gt_boxes"],
                d["gt_labels"])
        kw = {k: d[k] for k in ("crowd_boxes", "crowd_labels", "gt_areas")}
        pev.add(*args, **kw)
        jev.add(*args, **kw)
    got, want = pev.summarize(), jev.summarize()
    assert got.keys() == want.keys() and len(got) >= 12
    for k in want:
        np.testing.assert_equal(got[k], want[k], err_msg=k)
    assert 0 < got["AP"] < 100
    np.testing.assert_equal(pev.per_category_ap(), jev.per_category_ap())


def test_postprocess_matches_jax():
    """Top-k over (query x category) with the ties of categories a caption
    lacks (logit -100), then the boxes in original-image pixels."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 12, 8).astype(np.float32) * 3
    logits[..., 5:] = -100.0
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (2, 12, 2)),
                            rng.uniform(0.05, 0.6, (2, 12, 2))], -1).astype(np.float32)
    orig = np.array([[480, 640], [375, 500]], np.int32)
    for k in (20, 96, 200):
        want = jpost.top_k_detections(jnp.asarray(logits), jnp.asarray(boxes), k=k)
        got = ppost.top_k_detections(torch.from_numpy(logits), torch.from_numpy(boxes), k=k)
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
        for key in ("scores", "boxes_cxcywh"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=POST_TOL)
        np.testing.assert_allclose(
            ppost.scale_to_original(got["boxes_cxcywh"], torch.from_numpy(orig)).numpy(),
            np.asarray(jpost.scale_to_original(want["boxes_cxcywh"], jnp.asarray(orig))),
            atol=POST_TOL * 640)


def test_inference_on_dataset_with_an_oracle_detector(dataset):
    """The ground truth fed back as detections through the evaluator loop
    (eval batches, real_count padding, crowds, areas): AP 100."""
    pds, _ = dataset
    pcfg, _ = _configs()
    loader = ploader.DataLoader(pds, tiny_tokenizer(), pcfg, batch_size=2, train=False,
                                max_text_len=32, max_categories=8)

    def oracle_fn(batch):
        from ziragroundingdino_torch.ops.box_ops import box_cxcywh_to_xyxy

        xyxy = box_cxcywh_to_xyxy(torch.from_numpy(batch["gt_boxes"]))
        orig = torch.from_numpy(batch["orig_sizes"]).float()
        scale = torch.stack([orig[:, 1], orig[:, 0], orig[:, 1], orig[:, 0]], -1)[:, None]
        return {"scores": torch.from_numpy(np.where(batch["gt_valid"], 0.9, 0.0)),
                "labels": torch.from_numpy(batch["gt_labels"]), "boxes": xyxy * scale}

    res = peval.inference_on_dataset(iter(loader), oracle_fn, num_classes=2, num_warmup=0,
                                     score_floor=0.5, class_names=["cat", "dog"])
    assert res["n_images"] == 5
    assert res["AP"] == pytest.approx(100.0, abs=1e-4)
    assert res["sec_per_img"] > 0 and set(res["per_category_AP"]) == {"cat", "dog"}


def test_load_image_matches_jax(tmp_path):
    from ziragroundingdino_tpu.utils.inference import load_image as jload_image

    image = np.random.RandomState(3).randint(0, 256, (300, 400, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "x.ppm"), image)
    pcfg, jcfg = pconfig.DataConfig(), jconfig.DataConfig()
    src, (pixels, mask), size = ptf.load_image(str(tmp_path / "x.ppm"), pcfg)
    jsrc, (jpixels, jmask), jsize = jload_image(str(tmp_path / "x.ppm"), jcfg)
    np.testing.assert_array_equal(src, jsrc)
    assert tuple(size) == tuple(jsize) == (800, 1067)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    std = np.asarray(pcfg.pixel_std, np.float32)
    assert np.abs((pixels - np.asarray(jpixels)) * std).max() <= LEVEL + 1e-3
