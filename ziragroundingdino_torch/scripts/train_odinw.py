"""Sequential incremental training over the ODinW suite with the PyTorch
port: per-task ZiRa fine-tuning with soft-freeze, the side branches merged
into the frozen ones between tasks, prompt memory, an optional text-replay
phase, and the final per-task (+ COCO retention) eval with the averaged AP
in `<output-dir>/result.json`. The port of the JAX package's
`scripts/train_odinw.py` (reference `train_multidatasets.py:473-580`,
`train_odinw13_zira.sh`).

    python -m ziragroundingdino_torch.scripts.train_odinw \\
        --checkpoint groundingdino_swint_ogc.pth --vocab vocab.txt \\
        --datasets-root datasets/odinw --suite odinw13 [--shot full] \\
        [--coco-json ... --coco-root ...] [--replay-iters N] [--fast-dev-run] \\
        [--no-remat] [--config-overrides swinb.json]

(`swinb.json` holding `{"model": {"backbone": "swin_B_384_22k"}}` trains
GroundingDINO-B.) It runs on the CUDA card unless `--device cpu` is given.
Data-parallel over N cards, one process each:

    torchrun --nproc-per-node N -m ziragroundingdino_torch.scripts.train_odinw \
        --mesh N --batch-size <global batch, a multiple of N> ...

Each rank trains on its slice of every global batch (DDP), computing what
one process computes on the whole batch; rank 0 writes the checkpoints, the
chained states and the report, and every rank writes its log
(`<output-dir>/log.txt`, `log.rank{r}.txt`).

As the JAX driver, it trains with remat on (`use_checkpoint` and
`use_transformer_ckpt`: the fusion and deformable encoder layers are
recomputed in the backward, the same gradients for less memory) unless
`--no-remat` is given or the overrides set them. A second run on the same
--output-dir restores each finished task from its `state_final.pt` and
resumes a cut task from its newest checkpoint.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np

LEFT_OUT = ("Not ported yet: tensor and sequence parallelism (--mesh's model and seq axes, "
            "ROADMAP Queue 1 item 6).")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from ziragroundingdino_torch.config import MODEL_PRESETS
    from ziragroundingdino_torch.parallel import mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], epilog=LEFT_OUT)
    ap.add_argument("--checkpoint", required=True, help="reference-format .pth")
    ap.add_argument("--vocab", required=True, help="bert-base-uncased vocab.txt")
    ap.add_argument("--datasets-root", default="datasets/odinw")
    ap.add_argument("--suite", default="odinw13", choices=["odinw13", "odinw35"])
    ap.add_argument("--shot", default="full", choices=["full", "1shot", "5shot", "10shot"])
    ap.add_argument("--preset", default="dualzerorepbranchgroundingdino",
                    choices=sorted(MODEL_PRESETS), help="a preset of config.MODEL_PRESETS")
    ap.add_argument("--output-dir", default="./output/odinw")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--softfreeze-factor", type=float, default=0.2)
    ap.add_argument("--shuffle", action="store_true",
                    help="shuffle the task order (train_multidatasets.py:482-484)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--fast-dev-run", action="store_true",
                    help="20 iterations a task (train_net.py:313-317)")
    ap.add_argument("--max-iter", type=int, default=0,
                    help="iterations a task (0: the shot regime's schedule, 10 epochs)")
    ap.add_argument("--checkpoint-period", type=int, default=0,
                    help="iterations between checkpoints (0: a quarter of the task)")
    ap.add_argument("--coco-json", default=None, help="COCO val json for the retention eval")
    ap.add_argument("--coco-root", default=None)
    ap.add_argument("--replay-iters", type=int, default=0,
                    help="length of the text-replay phase after the tasks (MemoryReplayer)")
    ap.add_argument("--ema-decay", type=float, default=0.0,
                    help="EMA decay of the trainable weights (util/ema.py:36-90); 0 disables")
    ap.add_argument("--eval-ema", action="store_true",
                    help="chain and evaluate the EMA weights instead of the raw ones "
                         "(util/ema.py:187-263, train_net.py:174-206)")
    ap.add_argument("--force-resume", action="store_true",
                    help="resume into an output dir stamped with other run args")
    ap.add_argument("--tasks", default=None,
                    help="comma-separated subset of the suite's task names")
    ap.add_argument("--config-overrides", default=None,
                    help="json {'model': {...}, 'data': {...}} over the preset")
    ap.add_argument("--no-remat", action="store_true",
                    help="keep the encoder's activations instead of recomputing them in the "
                         "backward: faster steps, more memory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    mesh.add_mesh_args(ap, "'data[,model[,seq]]' axis sizes, e.g. '8': data parallel over 8 "
                      "processes started by torchrun, one card each (model and seq, tensor "
                      "and sequence parallelism, are not ported); default: one process")
    return ap.parse_args(argv)


def check_stamp(args: argparse.Namespace, write: bool = True) -> None:
    """A resumed run that reuses chained state from a run with other args
    would corrupt the chain: compare the args that shape it with the stamp
    of the first run in --output-dir, and refuse a difference. Only
    `write` (rank 0) stamps a fresh directory."""
    stamp = {k: getattr(args, k) for k in (
        "suite", "shot", "preset", "seed", "lr", "batch_size", "softfreeze_factor", "shuffle",
        "ema_decay", "tasks", "replay_iters", "eval_ema", "max_iter", "fast_dev_run")}
    if args.config_overrides:
        with open(args.config_overrides) as f:
            stamp["config_overrides_sha"] = hashlib.sha256(f.read().encode()).hexdigest()[:16]
    os.makedirs(args.output_dir, exist_ok=True)
    stamp_path = os.path.join(args.output_dir, "run_stamp.json")
    if os.path.exists(stamp_path):
        with open(stamp_path) as f:
            prev = json.load(f)
        diff = {k: (prev.get(k), v) for k, v in stamp.items() if prev.get(k) != v}
        if diff and not args.force_resume:
            raise SystemExit(f"output dir {args.output_dir} was stamped with different run "
                             f"args: {diff}. Use a fresh --output-dir or --force-resume.")
    elif write:
        with open(stamp_path + ".tmp", "w") as f:
            json.dump(stamp, f, indent=2)
        os.replace(stamp_path + ".tmp", stamp_path)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    from ziragroundingdino_torch.parallel import mesh

    args = parse_args(argv)
    device, joined = mesh.init_mesh(args, args.batch_size)
    try:
        return _run(args, device)
    finally:
        if joined:
            from ziragroundingdino_torch.parallel import dist

            dist.destroy()


def _run(args: argparse.Namespace, device) -> Dict[str, float]:
    from ziragroundingdino_torch.parallel import dist
    from ziragroundingdino_torch.utils.io import setup_logger

    rank = dist.process_index()
    check_stamp(args, write=rank == 0)
    dist.barrier()
    log = setup_logger(args.output_dir, rank=rank)

    from ziragroundingdino_torch.config import (
        DataConfig,
        OptimizerConfig,
        ScheduleConfig,
        TrainConfig,
        load_config_overrides,
    )
    from ziragroundingdino_torch.data.coco import CocoDataset
    from ziragroundingdino_torch.data.loader import DataLoader
    from ziragroundingdino_torch.data.odinw import odinw_suite
    from ziragroundingdino_torch.eval.evaluator import inference_on_dataset, make_inference_fn
    from ziragroundingdino_torch.train.incremental import (
        IncrementalState,
        TaskSpec,
        augment_caption_with_learned_names,
        final_report,
        load_incremental_state,
        run_replay_phase,
        run_task,
        save_incremental_state,
        snapshot,
    )
    from ziragroundingdino_torch.train.optim import (
        Optimizer,
        set_trainable,
        trainable_patterns_for_cfg,
    )
    from ziragroundingdino_torch.train.trainer import Trainer, checkpoint_step, latest_checkpoint
    from ziragroundingdino_torch.utils.inference import load_model

    model_ov, data_ov = {}, {}
    if args.config_overrides:
        model_ov, data_ov = load_config_overrides(args.config_overrides)
    remat = not args.no_remat
    model_ov = {"use_checkpoint": remat, "use_transformer_ckpt": remat, **model_ov}
    lm = load_model(args.checkpoint, args.vocab, preset=args.preset, device=device,
                    **model_ov)
    model, tokenizer, cfg = lm.model, lm.tokenizer, lm.cfg
    device = lm.device
    dcfg = DataConfig(**data_ov)
    rng = np.random.RandomState(args.seed)

    tasks_meta = odinw_suite(args.suite, args.datasets_root, args.shot)
    if args.tasks:
        keep = {t.strip() for t in args.tasks.split(",") if t.strip()}
        unknown = keep - {t.name for t in tasks_meta}
        if unknown:
            raise SystemExit(f"--tasks not in suite {args.suite}: {sorted(unknown)}")
        tasks_meta = [t for t in tasks_meta if t.name in keep]
    if args.shuffle:
        rng.shuffle(tasks_meta)

    inference_fn = make_inference_fn(model, select_k=cfg.select_box_nums_for_evaluation)

    def eval_on(ds, params):
        model.load_state_dict(params)
        loader = DataLoader(ds, tokenizer, dcfg, batch_size=args.batch_size, train=False,
                            max_text_len=cfg.max_text_len, max_categories=cfg.max_categories)
        return inference_on_dataset(iter(loader), inference_fn,
                                    num_classes=len(ds.category_names),
                                    class_names=ds.category_names)

    def make_eval_fn(task_meta):
        return lambda params: eval_on(task_meta.load_test(), params)

    def make_trainer(task_params, task):
        model.load_state_dict(task_params)
        set_trainable(model, trainable_patterns_for_cfg(cfg), freeze_all=cfg.freeze_all)
        # a fresh optimizer per task: no moments of merged branches carry over
        opt = Optimizer(
            model,
            OptimizerConfig(lr=args.lr, grad_clip=0.1,
                            lr_factors=(("freeze", args.softfreeze_factor),)),
            ScheduleConfig(max_iter=task.max_iter, milestones_frac=(0.4,), gamma=0.1),
            ema_decay=args.ema_decay if args.ema_decay > 0 else None)
        task_dir = os.path.join(args.output_dir, task.name)
        # mid-task resume: the loader skips the checkpointed iterations' batches
        marker = latest_checkpoint(os.path.join(task_dir, "ckpt"))
        start = checkpoint_step(marker) if marker else 0
        if start:
            log.info("task %s: mid-task checkpoint at iter %d", task.name, start)
        checkpoint_period = args.checkpoint_period or max(task.max_iter // 4, 1)
        tcfg = TrainConfig(output_dir=task_dir, max_iter=task.max_iter, seed=args.seed,
                           log_period=20, checkpoint_period=checkpoint_period,
                           fast_dev_run=args.fast_dev_run)
        tr = Trainer(model, opt, task.train_loader_fn(start_batch=start), tcfg)

        def extract():
            params = snapshot(model)
            if args.eval_ema and opt.ema is not None:
                # the EMA covers the trainable weights; the rest chain as they are
                params.update({n: e.detach().clone() for n, e in opt.ema.items()})
            return params

        return tr, extract

    state = IncrementalState(params=snapshot(model), prompt_memory=dict(lm.prompt_memory))
    tasks = []
    for ti, tm in enumerate(tasks_meta):
        ds_train = tm.load_train(filter_empty=False)

        def loader_fn(start_batch=0, ds=ds_train, ti=ti):
            # RNGs keyed on the task index: a resumed run that skips finished
            # tasks draws the same captions and batches as an uninterrupted one
            task_rng = np.random.RandomState((args.seed * 1000003 + ti) % 2**32)
            names = ds.category_names
            if cfg.use_add_names and cfg.use_learned_names:
                names = augment_caption_with_learned_names(
                    names, state.learned_classes, cfg.num_select_prompt, task_rng)
            return iter(DataLoader(
                ds, tokenizer, dcfg, batch_size=args.batch_size, train=True,
                max_text_len=cfg.max_text_len, max_categories=cfg.max_categories,
                caption=".".join(names) + ".", seed=args.seed + ti, start_batch=start_batch))

        max_iter = args.max_iter or (20 if args.fast_dev_run else tm.max_iter)
        task = TaskSpec(name=tm.name, train_loader_fn=loader_fn, eval_fn=make_eval_fn(tm),
                        class_names=ds_train.category_names, max_iter=max_iter)
        tasks.append(task)
        chain_path = os.path.join(args.output_dir, task.name, "state_final.pt")
        if os.path.exists(chain_path):
            log.info("=== task %s already done; restoring ===", tm.name)
            state = load_incremental_state(chain_path, device)
            continue
        log.info("=== task %s (%d classes) ===", tm.name, len(task.class_names))
        state = run_task(state, task, model, make_trainer, tokenizer)
        if rank == 0:
            save_incremental_state(chain_path, state)
        dist.barrier()

    if args.replay_iters > 0:
        log.info("=== replay phase (%d iters) ===", args.replay_iters)
        state = run_replay_phase(state, model, tokenizer, iters=args.replay_iters)

    coco_eval_fn = None
    if args.coco_json:
        def coco_eval_fn(params):
            return eval_on(CocoDataset.from_json(args.coco_json, args.coco_root), params)

    report = final_report(state, tasks, coco_eval_fn)
    if rank == 0:
        with open(os.path.join(args.output_dir, "result.json"), "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(report, indent=2))
    dist.barrier()
    return report


if __name__ == "__main__":
    main()
