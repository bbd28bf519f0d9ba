"""Result visualizer (matplotlib, imported only where drawn), the port of
the JAX package's `utils/visualizer.py` (reference `util/visualizer.py:
22-318`: `COCOVisualizer.visualize/addtgt/showAnns`, `ColorMap`, `renorm`).
Images are channels-last numpy arrays normalized with the 0-255 pixel
mean/std of `DataConfig`, boxes normalized cxcywh. RLE masks are decoded by
`rle_decode` (column-major runs, as the COCO spec), without pycocotools.

matplotlib is imported inside the drawing methods, so the module imports
where matplotlib is not installed.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["renorm", "ColorMap", "rle_decode", "COCOVisualizer"]


def renorm(
    img: np.ndarray,
    mean: Sequence[float] = (123.675, 116.28, 103.53),
    std: Sequence[float] = (58.395, 57.12, 57.375),
) -> np.ndarray:
    """Undo `data/transforms.normalize` on an [H, W, 3] or [B, H, W, 3]
    array; returns float RGB in [0, 1] for imshow (reference `renorm`,
    `util/visualizer.py:22-47`, adapted to channels-last and this repo's
    0-255 pixel stats)."""
    img = np.asarray(img, np.float32)
    assert img.ndim in (3, 4) and img.shape[-1] == 3, img.shape
    out = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(out / 255.0, 0.0, 1.0)


class ColorMap:
    """Constant-hue heatmap: attention strength rides the alpha channel
    (reference `ColorMap`, `util/visualizer.py:50-63`)."""

    def __init__(self, basergb=(255, 255, 0)):
        self.basergb = np.asarray(basergb, np.uint8)

    def __call__(self, attnmap: np.ndarray) -> np.ndarray:
        assert attnmap.dtype == np.uint8, attnmap.dtype
        h, w = attnmap.shape
        rgb = np.broadcast_to(self.basergb, (h, w, 3))
        return np.concatenate((rgb, attnmap[..., None]), axis=-1)


def rle_decode(segmentation: Dict, height: int, width: int) -> np.ndarray:
    """Decode a COCO segmentation dict to a [H, W] uint8 mask.

    Handles uncompressed RLE (``counts`` is a list of run lengths, column-
    major / Fortran order per the COCO spec) and the compressed LEB128-style
    string encoding produced by pycocotools' `maskUtils.encode`. Replaces
    the reference's `maskUtils.frPyObjects/decode` calls
    (`util/visualizer.py:256-262`) without the pycocotools dependency.
    """
    counts = segmentation["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        # pycocotools compressed RLE: 6-bit varint stream with delta coding
        nums: List[int] = []
        pos = 0
        while pos < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = counts[pos] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                pos += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(nums) > 2:
                x += nums[-2]
            nums.append(x)
        counts = nums
    flat = np.zeros(height * width, np.uint8)
    val, idx = 0, 0
    for run in counts:
        flat[idx:idx + run] = val
        idx += run
        val = 1 - val
    # COCO RLE is column-major
    return flat.reshape((width, height)).T


def _rand_color(rng: np.random.Generator) -> List[float]:
    return list(rng.random(3) * 0.6 + 0.4)


class COCOVisualizer:
    """Debug visualizer for model targets/predictions + raw COCO anns
    (reference `COCOVisualizer`, `util/visualizer.py:95-318`).

    `visualize` takes the channels-last image the rest of this repo uses and
    a tgt dict with normalized cxcywh ``boxes`` and ``size`` = (H, W);
    optional keys mirror the reference: ``image_id``, ``caption``,
    ``box_label``, ``strings_positive`` (+``labels``), and ``attn`` as one
    or a list of (attn_map, basergb) heatmap overlays.
    """

    def __init__(self, coco=None, seed: Optional[int] = None) -> None:
        # `coco` is any object with an `imgs` id->info dict (our CocoDataset
        # or a raw dict); only needed for crowd-RLE anns in showAnns
        self.coco = coco
        self._rng = np.random.default_rng(seed)

    def visualize(self, img, tgt, caption=None, dpi=180, savedir="vis",
                  show=False) -> str:
        """Render one image + targets and save it under `savedir`; returns
        the saved path (reference prints it, `util/visualizer.py:99-133`)."""
        import matplotlib.pyplot as plt

        fig = plt.figure(dpi=dpi)
        plt.rcParams["font.size"] = "5"
        ax = plt.gca()
        ax.imshow(renorm(np.asarray(img)))

        self.addtgt(tgt)

        image_id = 0 if (tgt is None or "image_id" not in tgt) else tgt["image_id"]
        stamp = str(datetime.datetime.now()).replace(" ", "-")
        if caption is None:
            savename = f"{savedir}/{int(image_id)}-{stamp}.png"
        else:
            savename = f"{savedir}/{caption}-{int(image_id)}-{stamp}.png"
        os.makedirs(os.path.dirname(savename), exist_ok=True)
        plt.savefig(savename)
        if show:  # pragma: no cover - interactive path
            plt.show()
        plt.close(fig)
        return savename

    def addtgt(self, tgt) -> None:
        """Draw tgt boxes/labels/caption/attention onto the current axes
        (reference `addtgt`, `util/visualizer.py:135-223`)."""
        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon

        ax = plt.gca()
        if tgt is None or "boxes" not in tgt:
            if tgt and "caption" in tgt:
                ax.set_title(tgt["caption"], wrap=True)
            ax.set_axis_off()
            return

        H, W = tgt["size"]
        tboxes = np.asarray(tgt["boxes"], np.float32).reshape(-1, 4)
        numbox = tboxes.shape[0]

        color, polygons, boxes = [], [], []
        for box in tboxes:
            cx, cy, bw, bh = box * np.asarray([W, H, W, H], np.float32)
            x, y = cx - bw / 2, cy - bh / 2
            boxes.append([x, y, bw, bh])
            poly = np.asarray(
                [[x, y], [x, y + bh], [x + bw, y + bh], [x + bw, y]])
            polygons.append(Polygon(poly))
            color.append(_rand_color(self._rng))

        ax.add_collection(
            PatchCollection(polygons, facecolor=color, linewidths=0, alpha=0.1))
        ax.add_collection(
            PatchCollection(polygons, facecolor="none", edgecolors=color,
                            linewidths=2))

        if tgt.get("strings_positive"):
            sp = tgt["strings_positive"]
            assert len(sp) == numbox, f"{len(sp)} != {numbox}"
            for idx, strlist in enumerate(sp):
                cate_id = int(np.asarray(tgt["labels"]).reshape(-1)[idx])
                _string = str(cate_id) + ":" + " ".join(strlist)
                x, y = boxes[idx][:2]
                ax.text(x, y, _string, color="black",
                        bbox={"facecolor": color[idx], "alpha": 0.6, "pad": 1})

        if "box_label" in tgt:
            bl = list(tgt["box_label"])
            assert len(bl) == numbox, f"{len(bl)} != {numbox}"
            for idx, label in enumerate(bl):
                x, y = boxes[idx][:2]
                ax.text(x, y, str(label), color="black",
                        bbox={"facecolor": color[idx], "alpha": 0.6, "pad": 1})

        if "caption" in tgt:
            ax.set_title(tgt["caption"], wrap=True)

        if "attn" in tgt:
            attns = tgt["attn"] if isinstance(tgt["attn"], list) else [tgt["attn"]]
            for attn_map, basergb in attns:
                attn_map = np.asarray(attn_map, np.float32)
                attn_map = (attn_map - attn_map.min()) / (
                    attn_map.max() - attn_map.min() + 1e-3)
                heatmap = ColorMap(basergb)((attn_map * 255).astype(np.uint8))
                ax.imshow(heatmap)
        ax.set_axis_off()

    def showAnns(self, anns: List[Dict], draw_bbox: bool = False) -> None:
        """Overlay raw COCO annotations — polygon segmentations, RLE crowd
        masks, keypoint skeletons, caption anns (reference `showAnns`,
        `util/visualizer.py:225-318`)."""
        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon

        if len(anns) == 0:
            return
        if "segmentation" in anns[0] or "keypoints" in anns[0]:
            dataset_type = "instances"
        elif "caption" in anns[0]:
            dataset_type = "captions"
        else:
            raise ValueError("datasetType not supported")

        if dataset_type == "captions":
            for ann in anns:
                print(ann["caption"])
            return

        ax = plt.gca()
        ax.set_autoscale_on(False)
        polygons, color = [], []
        for ann in anns:
            c = _rand_color(self._rng)
            seg = ann.get("segmentation")
            if isinstance(seg, list):
                for s in seg:
                    poly = np.asarray(s, np.float32).reshape(-1, 2)
                    polygons.append(Polygon(poly))
                    color.append(c)
            elif isinstance(seg, dict):
                if "size" in seg:
                    h, w = seg["size"]
                else:
                    info = self.coco.imgs[ann["image_id"]]
                    h, w = info["height"], info["width"]
                m = rle_decode(seg, h, w)
                if ann.get("iscrowd", 0) == 1:
                    cm = np.asarray([2.0, 166.0, 101.0]) / 255
                else:
                    cm = self._rng.random(3)
                overlay = np.empty((h, w, 4), np.float32)
                overlay[..., :3] = cm
                overlay[..., 3] = m * 0.5
                ax.imshow(overlay)
            if isinstance(ann.get("keypoints"), list):
                kp = np.asarray(ann["keypoints"], np.float32)
                x, y, v = kp[0::3], kp[1::3], kp[2::3]
                skeleton = ann.get("skeleton")
                if skeleton is None and self.coco is not None:
                    cats = getattr(self.coco, "cats", {})
                    skeleton = cats.get(ann.get("category_id"), {}).get("skeleton")
                for sk in np.asarray(skeleton or [], np.int64) - 1:
                    if np.all(v[sk] > 0):
                        plt.plot(x[sk], y[sk], linewidth=3, color=c)
                plt.plot(x[v > 0], y[v > 0], "o", markersize=8,
                         markerfacecolor=c, markeredgecolor="k",
                         markeredgewidth=2)
                plt.plot(x[v > 1], y[v > 1], "o", markersize=8,
                         markerfacecolor=c, markeredgecolor=c,
                         markeredgewidth=2)
            if draw_bbox:
                x, y, bw, bh = ann["bbox"]
                poly = np.asarray(
                    [[x, y], [x, y + bh], [x + bw, y + bh], [x + bw, y]])
                polygons.append(Polygon(poly))
                color.append(c)

        ax.add_collection(
            PatchCollection(polygons, facecolor="none", edgecolors=color,
                            linewidths=2))
