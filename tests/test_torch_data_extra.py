"""The port's remaining host modules against the JAX package's, on the inputs
of the JAX package's own tests (`tests/test_{misc_components,losses_incvoc,
meta_splits,selfsup,lvis_map,aux_utils}.py`): few-shot subsets and their
json, the COCO caption, the incremental-VOC filters, the meta splits,
self-supervised proposals (under the same `RandomState`), VOC and LVIS mAP,
and the vision-language span maps. Every output is equal. Also: the port's
`utils/inference.py` has every public name of the JAX module, and its
`load_image` returns what the JAX one returns.
"""

import inspect
import json

import numpy as np
import pytest

from tests.common import tiny_tokenizer
from tests.test_lvis_map import boxes as lvis_boxes
from tests.test_selfsup import _synthetic_image
from ziragroundingdino_torch import config as pconfig
from ziragroundingdino_torch.data import builtin_meta as pmeta
from ziragroundingdino_torch.data import coco as pcoco
from ziragroundingdino_torch.data import fewshot as pfew
from ziragroundingdino_torch.data import incremental_voc as pvoc
from ziragroundingdino_torch.data import meta_splits as psplit
from ziragroundingdino_torch.data import selfsup as pself
from ziragroundingdino_torch.data.synthetic import write_ppm
from ziragroundingdino_torch.data.transforms import Sample as PSample
from ziragroundingdino_torch.eval.lvis_map import LvisMeanAP as PLvis
from ziragroundingdino_torch.eval.voc_map import VocMeanAP as PVoc
from ziragroundingdino_torch.text import vl_utils as pvl
from ziragroundingdino_torch.utils import inference as pinf
from ziragroundingdino_tpu import config as jconfig
from ziragroundingdino_tpu.data import builtin_meta as jmeta
from ziragroundingdino_tpu.data import coco as jcoco
from ziragroundingdino_tpu.data import fewshot as jfew
from ziragroundingdino_tpu.data import incremental_voc as jvoc
from ziragroundingdino_tpu.data import meta_splits as jsplit
from ziragroundingdino_tpu.data import selfsup as jself
from ziragroundingdino_tpu.data.transforms import Sample as JSample
from ziragroundingdino_tpu.eval.lvis_map import LvisMeanAP as JLvis
from ziragroundingdino_tpu.eval.voc_map import VocMeanAP as JVoc
from ziragroundingdino_tpu.text import vl_utils as jvl
from ziragroundingdino_tpu.utils import inference as jinf


def _datasets(**kw):
    """The same `CocoDataset` in both packages."""
    return pcoco.CocoDataset(**kw), jcoco.CocoDataset(**kw)


def _fields(ds):
    return (ds.image_root, ds.category_names, ds.cat_id_to_contiguous, ds.images,
            ds.anns_by_image)


def _assert_same_dataset(p, j):
    assert _fields(p) == _fields(j)
    for i in range(len(j)):
        ps, js = p.load_sample(i, read_image=False), j.load_sample(i, read_image=False)
        np.testing.assert_array_equal(ps.labels, js.labels)
        np.testing.assert_array_equal(ps.boxes, js.boxes)


# `tests/test_misc_components.py::test_fewshot_and_io`'s dataset: 20 images,
# one annotation each, two classes
FEW_IMAGES = [{"id": i, "file_name": f"{i}.jpg", "height": 10, "width": 10} for i in range(20)]
FEW_ANNS = {i: [{"id": i + 1, "image_id": i, "category_id": (i % 2) + 1, "bbox": [0, 0, 5, 5]}]
            for i in range(20)}


@pytest.mark.parametrize("shots,seed", [(1, 3), (2, 3), (2, 0), (5, 7), (30, 3)])
def test_fewshot_subset_and_json_match_jax(tmp_path, shots, seed):
    pds, jds = _datasets(image_root="/x", category_names=["a", "b"],
                         cat_id_to_contiguous={1: 0, 2: 1}, images=FEW_IMAGES,
                         anns_by_image=FEW_ANNS)
    _assert_same_dataset(pfew.fewshot_subset(pds, shots, seed), jfew.fewshot_subset(jds, shots, seed))
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    ppath = pfew.write_fewshot_json(pds, str(tmp_path / "p"), shots, seed)
    jpath = jfew.write_fewshot_json(jds, str(tmp_path / "j"), shots, seed)
    assert ppath.endswith(f"fewshot_train_shot{shots}_seed{seed}.json")
    assert ppath.split("/")[-1] == jpath.split("/")[-1]
    with open(ppath) as f, open(jpath) as g:
        assert json.load(f) == json.load(g)
    _assert_same_dataset(pcoco.CocoDataset.from_json(ppath, "/x"),
                         jcoco.CocoDataset.from_json(jpath, "/x"))


def test_fewshot_defaults_match_jax():
    for fn in ("fewshot_subset", "write_fewshot_json"):
        assert (inspect.signature(getattr(pfew, fn)).parameters["seed"].default
                == inspect.signature(getattr(jfew, fn)).parameters["seed"].default == 3)


def test_builtin_meta_matches_jax():
    assert pmeta.COCO_CLASSES == jmeta.COCO_CLASSES
    assert pmeta.coco_caption() == jmeta.coco_caption()


# `tests/test_losses_incvoc.py::test_incremental_splits_and_filter`'s dataset
VOC_DS = dict(
    image_root="/x", category_names=["cat", "dog", "fish"],
    cat_id_to_contiguous={1: 0, 5: 1, 9: 2},
    images=[{"id": 1, "file_name": "a.jpg", "height": 10, "width": 10},
            {"id": 2, "file_name": "b.jpg", "height": 10, "width": 10}],
    anns_by_image={1: [{"category_id": 1, "bbox": [0, 0, 5, 5]}],
                   2: [{"category_id": 5, "bbox": [0, 0, 5, 5]},
                       {"category_id": 9, "bbox": [1, 1, 4, 4]}]})


@pytest.mark.parametrize("protocol", ["10+10", "15+5", "19+1"])
def test_incremental_splits_match_jax(protocol):
    assert pvoc.VOC_CLASSES == jvoc.VOC_CLASSES
    assert pvoc.INCREMENTAL_PROTOCOLS == jvoc.INCREMENTAL_PROTOCOLS
    assert (pvoc.incremental_splits(pvoc.VOC_CLASSES, protocol)
            == jvoc.incremental_splits(jvoc.VOC_CLASSES, protocol))


@pytest.mark.parametrize("keep,invert", [(["dog", "fish"], False), (["dog", "fish"], True),
                                         (["cat"], False), ([], True), (["bird"], False)])
def test_filter_classes_matches_jax(keep, invert):
    pds, jds = _datasets(**VOC_DS)
    _assert_same_dataset(pvoc.filter_classes(pds, keep, invert),
                         jvoc.filter_classes(jds, keep, invert))


def test_coco_without_voc_matches_jax():
    names = list(pmeta.COCO_CLASSES)
    rng = np.random.RandomState(0)
    images = [{"id": i, "file_name": f"{i}.jpg", "height": 20, "width": 20} for i in range(30)]
    anns = {i: [{"id": 100 * i + j, "image_id": i, "category_id": int(c) + 1,
                 "bbox": [1, 1, 5, 5]} for j, c in enumerate(rng.randint(0, 80, 3))]
            for i in range(30)}
    pds, jds = _datasets(image_root="/x", category_names=names,
                         cat_id_to_contiguous={i + 1: i for i in range(80)}, images=images,
                         anns_by_image=anns)
    got, want = pvoc.coco_without_voc(pds), jvoc.coco_without_voc(jds)
    _assert_same_dataset(got, want)
    assert len(got.category_names) == 60


def test_meta_splits_match_jax():
    assert psplit.VOC_CLASSES == jsplit.VOC_CLASSES
    assert psplit.VOC_NOVEL_SPLITS == jsplit.VOC_NOVEL_SPLITS
    assert psplit.COCO_NOVEL_CLASSES == jsplit.COCO_NOVEL_CLASSES
    for subset in ("novel", "base", "all"):
        assert psplit.coco_meta_split(subset) == jsplit.coco_meta_split(subset)
        for sid in (1, 2, 3):
            assert psplit.voc_meta_split(sid, subset) == jsplit.voc_meta_split(sid, subset)
    for fn, args in ((psplit.coco_meta_split, ("x",)), (psplit.voc_meta_split, (1, "x"))):
        with pytest.raises(ValueError):
            fn(*args)


# `tests/test_meta_splits.py`'s LVIS categories, with the json's
# `frequency` beside an `image_count`
LVIS_CATS = [
    ([{"id": 1, "name": "rare_thing", "image_count": 3},
      {"id": 2, "name": "common_thing", "image_count": 42},
      {"id": 3, "name": "freq_thing", "image_count": 4000},
      {"id": 4, "name": "edge", "image_count": 10},
      {"id": 5, "name": "tagged", "frequency": "f", "image_count": 1}], None),
    ([{"id": 7, "name": "x"}, {"id": 8, "name": "y"}, {"id": 9}],
     [{"category_id": 7, "image_id": i} for i in range(5)]
     + [{"category_id": 8, "image_id": i % 50} for i in range(70)]),
]


@pytest.mark.parametrize("case", range(len(LVIS_CATS)))
def test_lvis_splits_match_jax(case):
    cats, anns = LVIS_CATS[case]
    assert psplit.lvis_frequency_bands(cats, anns) == jsplit.lvis_frequency_bands(cats, anns)
    for subset in ("novel", "base", "all"):
        assert (psplit.lvis_meta_split(cats, subset, anns)
                == jsplit.lvis_meta_split(cats, subset, anns))
    if anns is not None:
        with pytest.raises(ValueError):
            psplit.lvis_frequency_bands(cats)


@pytest.mark.parametrize("classes,filter_empty", [(["c", "a"], False), (["b"], True),
                                                  (["a", "b", "c"], True)])
def test_filter_dataset_to_classes_matches_jax(classes, filter_empty):
    kw = dict(image_root="/none", category_names=["a", "b", "c"],
              cat_id_to_contiguous={10: 0, 20: 1, 30: 2},
              images=[{"id": 1, "height": 8, "width": 8, "file_name": "x"},
                      {"id": 2, "height": 8, "width": 8, "file_name": "y"}],
              anns_by_image={1: [{"category_id": 10, "bbox": [0, 0, 2, 2]},
                                 {"category_id": 30, "bbox": [1, 1, 2, 2]}],
                             2: [{"category_id": 20, "bbox": [0, 0, 2, 2]}]})
    pds, jds = _datasets(**kw)
    _assert_same_dataset(psplit.filter_dataset_to_classes(pds, classes, filter_empty),
                         jsplit.filter_dataset_to_classes(jds, classes, filter_empty))
    with pytest.raises(ValueError):
        psplit.filter_dataset_to_classes(pds, ["zzz"])


def test_felzenszwalb_and_hierarchy_match_jax():
    """`tests/test_selfsup.py`'s image at half its size (the JAX union-find
    loops in Python over every edge) and at a third."""
    img = _synthetic_image().astype(np.float32)[::2, ::2]
    labels = pself._felzenszwalb(img, k=300.0, min_size=20)
    np.testing.assert_array_equal(labels, jself._felzenszwalb(img, k=300.0, min_size=20))
    assert len(np.unique(labels)) >= 3  # the background and both rectangles
    small = _synthetic_image().astype(np.float32)[::3, ::3]
    labels = jself._felzenszwalb(small, k=150.0, min_size=20)
    np.testing.assert_array_equal(pself._region_boxes_and_hierarchy(labels, small, 64),
                                  jself._region_boxes_and_hierarchy(labels, small, 64))


@pytest.mark.parametrize("res_size,seed,max_boxes", [(96, 7, 256), (64, 0, 256), (128, 3, 10)])
def test_selective_patch_boxes_match_jax(res_size, seed, max_boxes):
    """The same proposals, and the RandomState left at the same place."""
    img = _synthetic_image()
    prng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    got = pself.selective_patch_boxes(img, prng, res_size=res_size, max_boxes=max_boxes)
    want = jself.selective_patch_boxes(img, jrng, res_size=res_size, max_boxes=max_boxes)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert prng.rand() == jrng.rand()


@pytest.mark.parametrize("shape,size", [((240, 320), (96, 96)), ((240, 320), (128, 128)),
                                        ((37, 50), (81, 9)), ((64, 64), (64, 32))])
def test_proposal_resize_is_pillows(shape, size):
    from PIL import Image

    image = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(image).resize(size[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(pself.resize_bilinear_pil(image, *size), want)


def test_selfsup_map_matches_jax():
    """`tests/test_selfsup.py::test_selfsup_map_train_and_eval`'s sample: the
    train map draws the same augmentation (its image within one uint8 level:
    the port resizes with torch) and, on its own image, the proposals JAX
    draws there from the same RandomState; the eval map drops the targets."""
    img = _synthetic_image()
    kw = dict(image=img, boxes=np.array([[60, 40, 140, 120]], np.float32),
              labels=np.array([0], np.int64), orig_size=img.shape[:2])
    dkw = dict(train_short_sides=(224,), test_short_side=224, max_size=384)
    pcfg, jcfg = pconfig.DataConfig(**dkw), jconfig.DataConfig(**dkw)
    prng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    got = pself.selfsup_map(PSample(**kw), pcfg, prng, is_train=True, res_size=64)
    want = jself.selfsup_map(JSample(**kw), jcfg, jrng, is_train=True, res_size=64)
    assert got.sample.image.shape == want.sample.image.shape
    assert np.abs(got.sample.image.astype(int) - want.sample.image).max() <= 1
    np.testing.assert_allclose(got.sample.boxes, want.sample.boxes, rtol=1e-6)
    np.testing.assert_array_equal(got.sample.labels, want.sample.labels)
    # JAX's proposals on the port's augmented image, from the state JAX's
    # augmentation left
    again = np.random.RandomState(3)
    jself.train_transform(JSample(**kw), jcfg, again)
    np.testing.assert_array_equal(
        got.patch_boxes, jself.selective_patch_boxes(got.sample.image, again, res_size=64))
    assert len(got.patch_boxes) > 0

    pev = pself.selfsup_map(PSample(**kw), pcfg, is_train=False)
    jev = jself.selfsup_map(JSample(**kw), jcfg, is_train=False)
    assert pev.sample.boxes.shape == jev.sample.boxes.shape == (0, 4)
    assert pev.patch_boxes.shape == jev.patch_boxes.shape == (0, 4)
    np.testing.assert_array_equal(pev.sample.labels, jev.sample.labels)


def _voc_cases():
    """`tests/test_aux_utils.py`'s VOC inputs, and a seeded many-class one."""
    gt = np.array([[0, 0, 50, 50], [100, 100, 150, 150]], np.float32)
    det = np.array([[0, 0, 50, 50], [300, 300, 340, 340]], np.float32)
    two = np.zeros(2, np.int64)
    cases = [
        [(0, det, np.array([0.9, 0.8]), two, gt, two, None)],
        [(0, gt[::-1].copy(), np.array([0.95, 0.9], np.float32), two, gt, two,
          np.array([False, True]))],
        [(0, gt[1:], np.array([0.95], np.float32), two[:1], gt, two, np.array([True, True]))],
    ]
    rng = np.random.RandomState(4)
    seeded = []
    for i in range(6):
        g = rng.uniform(0, 80, (5, 2))
        gb = np.concatenate([g, g + rng.uniform(5, 40, (5, 2))], 1).astype(np.float32)
        db = (np.concatenate([gb, gb[:3] + rng.uniform(-8, 8, (3, 4))])
              + rng.uniform(-3, 3, (8, 4))).astype(np.float32)
        seeded.append((i, db, rng.rand(8).astype(np.float32), rng.randint(0, 3, 8), gb,
                       rng.randint(0, 3, 5), rng.rand(5) > 0.8))
    cases.append(seeded)
    return cases


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("use_07", [False, True])
def test_voc_map_matches_jax(case, use_07):
    entries = _voc_cases()[case]
    n = 3 if case == 3 else 1
    pev, jev = PVoc(num_classes=n, use_07_metric=use_07), JVoc(num_classes=n, use_07_metric=use_07)
    for e in entries:
        pev.add(*e[:6], gt_difficult=e[6])
        jev.add(*e[:6], gt_difficult=e[6])
    got, want = pev.summarize(), jev.summarize()
    np.testing.assert_array_equal(got["per_class_AP"], want["per_class_AP"])
    assert got["mAP"] == want["mAP"] or (np.isnan(got["mAP"]) and np.isnan(want["mAP"]))


def _lvis_cases():
    """`tests/test_lvis_map.py`'s inputs: (num_classes, frequencies, images
    as (id, det boxes, scores, labels, gt boxes, gt labels, negatives, not
    exhaustive))."""
    gt, fp = lvis_boxes([0, 0, 50, 50]), lvis_boxes([200, 200, 240, 240])
    none, empty = np.zeros((0, 4)), np.array([])
    both = np.concatenate([gt, fp])
    two_gt = np.concatenate([gt, lvis_boxes([100, 100, 150, 150])])
    return [
        (1, None, [(0, gt, [0.9], [0], gt, [0], [], []), (1, fp, [0.8], [0], none, empty, [], []),
                   (2, fp, [0.7], [0], none, empty, [0], [])]),
        (1, None, [(0, gt, [0.6], [0], gt, [0], [], []), (2, fp, [0.7], [0], none, empty, [0], [])]),
        (1, None, [(0, both, [0.9, 0.8], [0, 0], gt, [0], [], [0])]),
        (1, None, [(0, both, [0.8, 0.9], [0, 0], gt, [0], [], [])]),
        (1, None, [(0, both, [0.8, 0.9], [0, 0], gt, [0], [], [0])]),
        (2, ["r", "f"], [(0, gt, [0.9], [0], gt, [0], [], []),
                         (1, gt, [0.2], [1], two_gt, [1, 1], [], [])]),
    ]


@pytest.mark.parametrize("case", range(6))
def test_lvis_map_matches_jax(case):
    n, freq, images = _lvis_cases()[case]
    pev = PLvis(num_classes=n, category_frequency=freq)
    jev = JLvis(num_classes=n, category_frequency=freq)
    for img_id, db, ds, dl, gb, gl, neg, nex in images:
        for ev in (pev, jev):
            ev.add(img_id, db, np.array(ds), np.array(dl), gb, np.array(gl))
            ev.add_image_meta(img_id, neg, nex)
    got, want = pev.summarize(), jev.summarize()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("cats,lower", [(["cat", "dog"], True), (["Cat", "zebra", "fish"], True),
                                        (["Cat", "dog"], False), (["person"], True)])
def test_vl_utils_match_jax(cats, lower):
    tok = tiny_tokenizer()
    caption, spans = pvl.build_captions_and_token_span(cats, lower)
    assert (caption, spans) == jvl.build_captions_and_token_span(cats, lower)
    for text in (caption, "a cat. dogs and zebras!", "personfish . çat ."):
        assert pvl.encode_with_offsets(tok, text) == jvl.encode_with_offsets(tok, text)
    for max_len in (16, 4):
        got = pvl.create_positive_map_from_span(tok, caption, list(spans.values()), max_len)
        want = jvl.create_positive_map_from_span(tok, caption, list(spans.values()), max_len)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _defined_names(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__}


def test_inference_api_has_the_jax_names():
    names = _defined_names(jinf)
    assert {"load_model", "load_image", "predict", "annotate"} <= names
    missing = names - set(dir(pinf))
    assert not missing, missing


def test_load_image_through_the_inference_api_matches_jax(tmp_path):
    image = np.random.RandomState(3).randint(0, 256, (300, 400, 3), dtype=np.uint8)
    write_ppm(str(tmp_path / "x.ppm"), image)
    cfg = dict(test_short_side=224, max_size=384, shape_buckets=((224, 320), (256, 384)))
    for pcfg, jcfg in ((None, None), (pconfig.DataConfig(**cfg), jconfig.DataConfig(**cfg))):
        src, (pixels, mask), size = pinf.load_image(str(tmp_path / "x.ppm"), pcfg)
        jsrc, (jpixels, jmask), jsize = jinf.load_image(str(tmp_path / "x.ppm"), jcfg)
        np.testing.assert_array_equal(src, jsrc)
        assert tuple(size) == tuple(jsize)
        assert pixels.shape == np.asarray(jpixels).shape and pixels.dtype == np.float32
        np.testing.assert_array_equal(mask, np.asarray(jmask))
        std = np.asarray((pcfg or pconfig.DataConfig()).pixel_std, np.float32)
        assert np.abs((pixels - np.asarray(jpixels)) * std).max() <= 1 + 1e-3
    assert inspect.signature(pinf.load_image).parameters["cfg"].default is None
