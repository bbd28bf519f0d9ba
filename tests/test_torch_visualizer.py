"""The port's visualizer and `visualize_json_results` script against the JAX
package's, on `tests/test_visualizer.py`'s cases: `renorm`, `ColorMap` and
`rle_decode` equal; `COCOVisualizer.visualize` and `showAnns` drawing the
same pixels (matplotlib's Agg backend, where matplotlib is installed); the
script writing the same images. The port's module imports without
matplotlib (`tests/test_torch_weights.py::test_port_imports_no_jax`).
"""

import json
import pathlib

import numpy as np
import pytest

from ziragroundingdino_torch.utils import visualizer as pvis
from ziragroundingdino_tpu.utils import visualizer as jvis


def _plt():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


@pytest.mark.parametrize("batched", [False, True])
def test_renorm_matches_jax(batched):
    rng = np.random.default_rng(0)
    normed = rng.normal(size=(8, 6, 3)).astype(np.float32) * 2
    if batched:
        normed = normed[None]
    got = pvis.renorm(normed)
    np.testing.assert_array_equal(got, jvis.renorm(normed))
    assert got.shape == normed.shape


def test_colormap_matches_jax():
    attn = np.arange(12, dtype=np.uint8).reshape(3, 4)
    for base in ((255, 0, 0), (255, 255, 0)):
        got, want = pvis.ColorMap(base)(attn), jvis.ColorMap(base)(attn)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def _rle_encode_compressed(counts):
    """pycocotools' `rleToString` (`tests/test_visualizer.py`'s copy, which
    imports matplotlib with its module): 6-bit varints, delta-coded from
    the 4th count on, offset by ASCII 48."""
    s = bytearray()
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            s.append(chunk + 48)
    return bytes(s)


def _runs(mask):
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for px in flat:
        if px == val:
            run += 1
        else:
            counts.append(run)
            val, run = px, 1
    counts.append(run)
    return counts


@pytest.mark.parametrize("kind", ["list", "bytes", "str"])
def test_rle_decode_matches_jax(kind):
    mask = (np.random.default_rng(3).random((17, 11)) < 0.4).astype(np.uint8)
    counts = _runs(mask)
    if kind != "list":
        counts = _rle_encode_compressed(counts)
        counts = counts.decode() if kind == "str" else counts
    got = pvis.rle_decode({"counts": counts}, 17, 11)
    np.testing.assert_array_equal(got, jvis.rle_decode({"counts": counts}, 17, 11))
    np.testing.assert_array_equal(got, mask)
    small = {"counts": [1, 2, 3], "size": [3, 2]}
    np.testing.assert_array_equal(pvis.rle_decode(small, 3, 2), jvis.rle_decode(small, 3, 2))


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_visualize_draws_as_jax(tmp_path):
    """The same targets through both packages' `visualize` (`tests/
    test_visualizer.py::test_visualize_writes_file`'s three): the same
    pixels in each saved file."""
    _plt()
    rng = np.random.default_rng(1)
    img = rng.normal(size=(32, 48, 3)).astype(np.float32)
    attn = rng.random((32, 48))
    targets = [
        ({"image_id": 7, "size": (32, 48),
          "boxes": np.asarray([[0.5, 0.5, 0.4, 0.6], [0.3, 0.2, 0.2, 0.2]]),
          "box_label": ["cat 0.91", "dog 0.55"], "caption": "cat. dog.",
          "attn": (attn, (255, 255, 0))}, None),
        ({"image_id": 8, "size": (32, 48), "boxes": np.asarray([[0.5, 0.5, 0.5, 0.5]]),
          "labels": np.asarray([2]), "strings_positive": [["striped", "cat"]]}, "q"),
        ({"caption": "no boxes"}, None),
    ]
    pv, jv = pvis.COCOVisualizer(seed=0), jvis.COCOVisualizer(seed=0)
    for i, (tgt, caption) in enumerate(targets):
        got = pv.visualize(img, tgt, caption=caption, savedir=str(tmp_path / f"p{i}"))
        want = jv.visualize(img, tgt, caption=caption, savedir=str(tmp_path / f"j{i}"))
        assert got.startswith(str(tmp_path / f"p{i}"))
        assert got.split("/")[-1].split("-")[0] == want.split("/")[-1].split("-")[0]
        np.testing.assert_array_equal(_read_png(got), _read_png(want))


def test_show_anns_draws_as_jax(capsys):
    plt = _plt()

    class FakeCoco:
        imgs = {1: {"height": 16, "width": 16}}
        cats = {3: {"skeleton": [[1, 2]]}}

    anns = [
        {"image_id": 1, "category_id": 3, "iscrowd": 0, "bbox": [1, 1, 6, 8],
         "segmentation": [[1, 1, 7, 1, 7, 9, 1, 9]], "keypoints": [2, 2, 2, 5, 6, 1]},
        {"image_id": 1, "category_id": 3, "iscrowd": 1, "bbox": [0, 0, 4, 4],
         "segmentation": {"counts": [4, 3, 249], "size": [16, 16]}},
        {"image_id": 1, "category_id": 3, "iscrowd": 0, "bbox": [2, 2, 3, 3],
         "segmentation": {"counts": [40, 5, 211]}},
    ]

    def draw(vis_mod):
        vis = vis_mod.COCOVisualizer(coco=FakeCoco(), seed=0)
        fig = plt.figure()
        plt.gca().imshow(np.zeros((16, 16, 3)))
        vis.showAnns(anns, draw_bbox=True)
        fig.canvas.draw()
        pixels = np.asarray(fig.canvas.buffer_rgba()).copy()
        plt.close(fig)
        vis.showAnns([{"caption": "a photo"}])
        return pixels

    got, want = draw(pvis), draw(jvis)
    np.testing.assert_array_equal(got, want)
    assert capsys.readouterr().out == "a photo\na photo\n"
    with pytest.raises(ValueError):
        pvis.COCOVisualizer().showAnns([{"bbox": [0, 0, 1, 1]}])


def _results_task(root):
    """Three PNG images, their instances json and a result json."""
    from PIL import Image

    rng = np.random.RandomState(0)
    images = []
    for i in range(3):
        name = f"img{i}.png"
        Image.fromarray(rng.randint(0, 256, (60, 80, 3), dtype=np.uint8)).save(root / name)
        images.append({"id": 10 + i, "file_name": name, "height": 60, "width": 80})
    (root / "instances.json").write_text(json.dumps(
        {"images": images, "categories": [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]}))
    results = [{"image_id": 10 + i % 3, "category_id": 1 + i % 3,
                "bbox": [float(v) for v in rng.uniform(0, 40, 4)],
                "score": float(rng.rand())} for i in range(12)]
    (root / "results.json").write_text(json.dumps(results))


@pytest.mark.parametrize("max_images,threshold", [(50, 0.3), (2, 0.0)])
def test_visualize_json_results_matches_jax(tmp_path, monkeypatch, max_images, threshold):
    """The port's script and the JAX package's on the same result json:
    the same images written, with the same pixels."""
    import runpy
    import sys

    pytest.importorskip("PIL")
    from ziragroundingdino_torch.scripts import visualize_json_results

    _results_task(tmp_path)
    common = ["--input", str(tmp_path / "results.json"), "--dataset-json",
              str(tmp_path / "instances.json"), "--image-root", str(tmp_path),
              "--conf-threshold", str(threshold), "--max-images", str(max_images)]
    written = visualize_json_results.main(common + ["--output", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["visualize_json_results.py"] + common
                        + ["--output", str(tmp_path / "jax")])
    runpy.run_path(str(pathlib.Path(__file__).resolve().parents[1] / "scripts"
                       / "visualize_json_results.py"), run_name="__main__")
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.split("/")[-1] for p in written) == want and want
    for name in want:
        np.testing.assert_array_equal(_read_png(tmp_path / "port" / name),
                                      _read_png(tmp_path / "jax" / name))


@pytest.mark.parametrize("seed", range(3))
def test_draw_boxes_outlines_as_pillow(seed, monkeypatch):
    """Without PIL, `utils.inference.draw_boxes` draws the outlines Pillow's
    `rectangle(width=2)` draws: boxes thinner than 4 pixels, boxes across
    the image's edges and at negative coordinates among them."""
    from PIL import Image, ImageDraw

    from ziragroundingdino_torch.utils.inference import draw_boxes

    rng = np.random.RandomState(seed)
    image = rng.randint(0, 200, (40, 60, 3)).astype(np.uint8)
    xy = rng.uniform(-10, 65, (30, 2))
    wh = np.where(rng.rand(30, 2) < 0.5, rng.uniform(0, 3, (30, 2)), rng.uniform(0, 40, (30, 2)))
    corners = [tuple(c) for c in np.concatenate([xy, xy + wh], 1)]
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    got = draw_boxes(image, corners, [""] * len(corners))
    monkeypatch.undo()
    ref = Image.fromarray(image.copy())
    draw = ImageDraw.Draw(ref)
    for c in corners:
        draw.rectangle(c, outline=(255, 0, 0), width=2)
    np.testing.assert_array_equal(got, np.asarray(ref))
