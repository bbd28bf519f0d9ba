"""Single-image open-set detection with the PyTorch port: load a model and an
image, ground a caption (or a list of class names) in it, keep the boxes
above the thresholds, and write the annotated image and the detections.
The port of the JAX package's `demo/inference_on_a_image.py` (reference
`demo/inference_on_a_image.py:122-172`).

    python -m ziragroundingdino_torch.scripts.inference_on_a_image \\
        -p groundingdino_swint_ogc.pth --vocab vocab.txt \\
        -i image.ppm -t "a cat. a dog." -o out/ [-c groundingdino] [--device cpu]

It runs on the CUDA card unless `--device cpu` is given. The image is read
with numpy when it is a binary PPM and with PIL otherwise (PIL is needed
only then). It writes `<output-dir>/pred.ppm`, the image with the boxes
drawn (`utils.inference.annotate`), and `<output-dir>/pred.json`, the
boxes (cxcywh, normalized), scores and phrases, and prints the JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from ziragroundingdino_torch.config import MODEL_PRESETS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", "-c", default="groundingdino", choices=sorted(MODEL_PRESETS))
    ap.add_argument("--checkpoint", "-p", required=True, help="reference-format .pth")
    ap.add_argument("--vocab", required=True, help="bert-base-uncased vocab.txt")
    ap.add_argument("--image", "-i", required=True)
    ap.add_argument("--text", "-t", default=None, help="free-form caption (phrase-decode mode)")
    ap.add_argument("--classes", default=None,
                    help="comma-separated class names (per-class logits mode, like "
                         "demo/inference_on_a_image_multi_classes.py)")
    ap.add_argument("--output-dir", "-o", default="outputs")
    ap.add_argument("--box-threshold", type=float, default=0.3)
    ap.add_argument("--text-threshold", type=float, default=0.25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    ap.add_argument("--config-overrides", default=None,
                    help="json {'model': {...}, 'data': {...}} over the preset")
    args = ap.parse_args(argv)
    if not args.text and not args.classes:
        ap.error("one of --text or --classes is required")
    return args


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)

    from ziragroundingdino_torch.config import DataConfig, load_config_overrides
    from ziragroundingdino_torch.data.synthetic import write_ppm
    from ziragroundingdino_torch.data.transforms import load_image
    from ziragroundingdino_torch.utils.inference import (
        annotate,
        load_model,
        predict,
        predict_classes,
    )

    model_ov, data_ov = {}, {}
    if args.config_overrides:
        model_ov, data_ov = load_config_overrides(args.config_overrides)
    os.makedirs(args.output_dir, exist_ok=True)
    lm = load_model(args.checkpoint, args.vocab, preset=args.preset, device=args.device,
                    **model_ov)
    image_source, (pixels, mask), _ = load_image(args.image, DataConfig(**data_ov))

    t0 = time.time()
    if args.classes:
        class_names = [c.strip() for c in args.classes.split(",") if c.strip()]
        boxes, scores, phrases = predict_classes(lm, pixels, mask, class_names,
                                                 box_threshold=args.box_threshold)
    else:
        boxes, scores, phrases = predict(lm, pixels, mask, args.text,
                                         box_threshold=args.box_threshold,
                                         text_threshold=args.text_threshold)
    print("time:", time.time() - t0)

    out_path = os.path.join(args.output_dir, "pred.ppm")
    write_ppm(out_path, annotate(image_source, boxes, scores, phrases))
    pred = {"boxes": boxes.tolist(), "scores": scores.tolist(), "phrases": phrases}
    with open(os.path.join(args.output_dir, "pred.json"), "w") as f:
        json.dump(pred, f, indent=2)
    print(json.dumps(pred, indent=2))
    print("saved:", out_path)
    return pred


if __name__ == "__main__":
    main()
