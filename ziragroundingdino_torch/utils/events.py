"""Metric writers, the port of the JAX package's `utils/events.py` (reference
`train_net.py:271-278`, `util/events.py:22-66`): the console printer, an
optional TensorBoard writer and an optional W&B writer (both no-ops where
their package is missing, as the reference gates `WandbWriter` behind
`train.wandb.enabled`), and the copy-paste result lines. The JSON writer
(`metrics.jsonl`) is the trainer's own."""

from __future__ import annotations

import logging
import time
from typing import Dict

logger = logging.getLogger("ziragroundingdino_torch")


class CommonMetricPrinter:
    """detectron2's `CommonMetricPrinter`: one line per logged iteration with
    every float metric, the time per iteration since the last line and the
    time left."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._last = None

    def write(self, step: int, metrics: Dict[str, float]):
        now = time.time()
        rate = ""
        if self._last is not None:
            dt = (now - self._last[0]) / max(step - self._last[1], 1)
            eta = dt * (self.max_iter - step)
            rate = f" iter_time: {dt:.3f}s eta: {eta / 60:.1f}min"
        self._last = (now, step)
        parts = " ".join(f"{k}: {v:.4g}" for k, v in sorted(metrics.items())
                         if isinstance(v, float))
        logger.info("iter %d/%d %s%s", step, self.max_iter, parts, rate)


class TensorboardWriter:
    """Scalars to TensorBoard through tensorboardX; a no-op without it."""

    def __init__(self, log_dir: str):
        self._w = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore

            self._w = SummaryWriter(log_dir)
        except ImportError:
            logger.info("tensorboardX unavailable; TensorboardWriter is a no-op")

    def write(self, step: int, metrics: Dict[str, float]):
        if self._w is None:
            return
        for k, v in metrics.items():
            self._w.add_scalar(k, v, step)

    def close(self):
        if self._w is not None:
            self._w.close()


class WandbWriter:
    """`util/events.py:22-66`: metrics to a W&B run; a no-op without wandb."""

    def __init__(self, project: str = "ziragroundingdino_torch", **kw):
        self._run = None
        try:
            import wandb  # type: ignore

            self._run = wandb.init(project=project, **kw)
        except Exception:
            logger.info("wandb unavailable; WandbWriter is a no-op")

    def write(self, step: int, metrics: Dict[str, float]):
        if self._run is None:
            return
        self._run.log(dict(metrics), step=step)

    def close(self):
        if self._run is not None:
            self._run.finish()


def print_csv_format(results: Dict[str, Dict[str, float]]):
    """`evaluation/testing.py:8-23`: per task, the metric names and their
    values as comma-separated lines to copy."""
    for task, metrics in results.items():
        logger.info("copypaste: Task: %s", task)
        keys = list(metrics.keys())
        logger.info("copypaste: %s", ",".join(keys))
        logger.info("copypaste: %s", ",".join(
            f"{metrics[k]:.4f}" if isinstance(metrics[k], float) else str(metrics[k])
            for k in keys))
