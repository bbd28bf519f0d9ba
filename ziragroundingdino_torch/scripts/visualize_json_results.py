"""Overlay detections from a COCO-format result json (image_id, bbox xywh,
score, category_id) onto their images, the port of the JAX package's
`scripts/visualize_json_results.py` (reference `visualize_json_results.py`):
per image, the detections at or above `--conf-threshold` are drawn in
score order, for at most `--max-images` images in image-id order.

    python -m ziragroundingdino_torch.scripts.visualize_json_results \\
        --input results.json --dataset-json instances.json \\
        --image-root images/ --output vis/

Boxes are drawn on the numpy array (`utils.inference.draw_boxes`); the
labels ("name score") and an output in the image's own format need PIL,
where it is installed. Without PIL an image is read only as a binary PPM,
and written as `<name>.ppm` without its labels.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True, help="COCO-format results json")
    ap.add_argument("--dataset-json", required=True, help="instances json (for file names)")
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--conf-threshold", type=float, default=0.3)
    ap.add_argument("--max-images", type=int, default=50)
    return ap.parse_args(argv)


def _write(path: str, image) -> str:
    """Writes `image` with PIL where installed, else as a PPM; returns the path."""
    try:
        from PIL import Image
    except ImportError:
        from ziragroundingdino_torch.data.synthetic import write_ppm

        path = os.path.splitext(path)[0] + ".ppm"
        write_ppm(path, image)
        return path
    Image.fromarray(image).save(path)
    return path


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the paths written."""
    args = parse_args(argv)

    from ziragroundingdino_torch.data.transforms import read_image
    from ziragroundingdino_torch.utils.inference import draw_boxes

    with open(args.dataset_json) as f:
        coco = json.load(f)
    id_to_file = {im["id"]: im["file_name"] for im in coco["images"]}
    id_to_cat = {c["id"]: c["name"] for c in coco.get("categories", [])}
    with open(args.input) as f:
        results = json.load(f)
    by_image = defaultdict(list)
    for r in results:
        if r.get("score", 1.0) >= args.conf_threshold:
            by_image[r["image_id"]].append(r)

    os.makedirs(args.output, exist_ok=True)
    written = []
    for img_id, dets in sorted(by_image.items())[:args.max_images]:
        dets = sorted(dets, key=lambda x: -x.get("score", 1.0))
        corners = [(x, y, x + w, y + h) for x, y, w, h in (d["bbox"] for d in dets)]
        labels = [f"{id_to_cat.get(d.get('category_id'), str(d.get('category_id')))} "
                  f"{d.get('score', 0):.2f}" for d in dets]
        image = draw_boxes(read_image(os.path.join(args.image_root, id_to_file[img_id])),
                           corners, labels)
        written.append(_write(os.path.join(args.output, os.path.basename(id_to_file[img_id])),
                              image))
    print(f"wrote {len(written)} images to {args.output}")
    return written


if __name__ == "__main__":
    main()
