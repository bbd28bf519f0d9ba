"""COCO-style evaluation of a checkpoint with the PyTorch port (the
reference's `--eval-only` path, `train_net.py:174-206` -> `evaluation/
evaluator.py:82-158`), the port of the JAX package's `scripts/eval_coco.py`:
the 12 COCO metrics, images per second and the per-category AP of any
COCO-format dataset, printed and written to --output.

    python -m ziragroundingdino_torch.scripts.eval_coco \\
        --checkpoint groundingdino_swint_ogc.pth --vocab vocab.txt \\
        --json instances_val2017.json --image-root val2017/ [--batch-size 2]

It runs on the CUDA card unless `--device cpu` is given. Data-parallel
evaluation over several cards (the JAX script's --mesh) is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--json", required=True, help="COCO/LVIS instances json")
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--preset", default="dualzerorepbranchgroundingdino")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--max-images", type=int, default=0,
                    help="evaluate only the first N images (0 = all)")
    ap.add_argument("--output", default=None, help="write the metrics json here")
    ap.add_argument("--config-overrides", default=None,
                    help="json {'model': {...}, 'data': {...}} over the preset")
    ap.add_argument("--select-k", type=int, default=0,
                    help="top-k detections per image (0 = the preset's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ziragroundingdino_torch.config import DataConfig, load_config_overrides
    from ziragroundingdino_torch.data.coco import CocoDataset
    from ziragroundingdino_torch.data.loader import DataLoader
    from ziragroundingdino_torch.eval.evaluator import inference_on_dataset, make_inference_fn
    from ziragroundingdino_torch.utils.inference import load_model

    model_ov, data_ov = {}, {}
    if args.config_overrides:
        model_ov, data_ov = load_config_overrides(args.config_overrides)
    lm = load_model(args.checkpoint, args.vocab, preset=args.preset, device=args.device,
                    **model_ov)
    cfg = lm.cfg
    ds = CocoDataset.from_json(args.json, args.image_root)
    if args.max_images:
        ds.images = ds.images[: args.max_images]
    logging.info("dataset: %d images, %d categories", len(ds), len(ds.category_names))
    loader = DataLoader(ds, lm.tokenizer, DataConfig(**data_ov), batch_size=args.batch_size,
                        train=False, max_text_len=cfg.max_text_len,
                        max_categories=cfg.max_categories)
    inference_fn = make_inference_fn(lm.model,
                                     select_k=args.select_k or cfg.select_box_nums_for_evaluation)
    res = inference_on_dataset(iter(loader), inference_fn, num_classes=len(ds.category_names),
                               class_names=ds.category_names)
    print(json.dumps({k: v for k, v in res.items() if not isinstance(v, dict)}, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(res, f, indent=2)
        print("saved:", args.output)
    return res


if __name__ == "__main__":
    main()
