"""COCO-style evaluation of a checkpoint with the PyTorch port (the
reference's `--eval-only` path, `train_net.py:174-206` -> `evaluation/
evaluator.py:82-158`), the port of the JAX package's `scripts/eval_coco.py`:
the 12 COCO metrics, images per second and the per-category AP of any
COCO-format dataset, printed and written to --output.

    python -m ziragroundingdino_torch.scripts.eval_coco \\
        --checkpoint groundingdino_swint_ogc.pth --vocab vocab.txt \\
        --json instances_val2017.json --image-root val2017/ [--batch-size 2]

It runs on the CUDA card unless `--device cpu` is given. Data-parallel over
N cards, one process each (`torchrun --nproc-per-node N -m
ziragroundingdino_torch.scripts.eval_coco --mesh N ...`), each rank runs its
slice of every global batch and rank 0 scores them all: the metrics are one
process's.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    from ziragroundingdino_torch.config import MODEL_PRESETS
    from ziragroundingdino_torch.parallel import mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--json", required=True, help="COCO/LVIS instances json")
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--preset", default="dualzerorepbranchgroundingdino",
                    choices=sorted(MODEL_PRESETS), help="a preset of config.MODEL_PRESETS")
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
    mesh.add_mesh_args(ap, "data-parallel eval over N processes started by torchrun, one card "
                      "each (--batch-size must divide by N); default: one process")
    args = ap.parse_args(argv)
    device, _, joined = mesh.init_mesh(args, args.batch_size, data_only=True)
    try:
        return _run(args, device)
    finally:
        if joined:
            from ziragroundingdino_torch.parallel import dist

            dist.destroy()


def _run(args: argparse.Namespace, device) -> Dict:
    from ziragroundingdino_torch.config import DataConfig, load_config_overrides
    from ziragroundingdino_torch.data.coco import CocoDataset
    from ziragroundingdino_torch.data.loader import DataLoader
    from ziragroundingdino_torch.eval.evaluator import inference_on_dataset, make_inference_fn
    from ziragroundingdino_torch.parallel import dist
    from ziragroundingdino_torch.utils.events import print_csv_format
    from ziragroundingdino_torch.utils.inference import load_model
    from ziragroundingdino_torch.utils.io import setup_logger

    model_ov, data_ov = {}, {}
    if args.config_overrides:
        model_ov, data_ov = load_config_overrides(args.config_overrides)
    rank = dist.process_index()
    log = setup_logger(rank=rank)
    lm = load_model(args.checkpoint, args.vocab, preset=args.preset, device=device,
                    **model_ov)
    cfg = lm.cfg
    ds = CocoDataset.from_json(args.json, args.image_root)
    if args.max_images:
        ds.images = ds.images[: args.max_images]
    log.info("dataset: %d images, %d categories", len(ds), len(ds.category_names))
    loader = DataLoader(ds, lm.tokenizer, DataConfig(**data_ov), batch_size=args.batch_size,
                        train=False, max_text_len=cfg.max_text_len,
                        max_categories=cfg.max_categories)
    inference_fn = make_inference_fn(lm.model,
                                     select_k=args.select_k or cfg.select_box_nums_for_evaluation)
    res = inference_on_dataset(iter(loader), inference_fn, num_classes=len(ds.category_names),
                               class_names=ds.category_names)
    if rank == 0:
        metrics = {k: v for k, v in res.items() if not isinstance(v, dict)}
        print(json.dumps(metrics, indent=2))
        print_csv_format({os.path.basename(args.json): metrics})
        if args.output:
            with open(args.output, "w") as f:
                json.dump(res, f, indent=2)
            print("saved:", args.output)
    return res


if __name__ == "__main__":
    main()
