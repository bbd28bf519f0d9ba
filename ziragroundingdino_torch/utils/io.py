"""Serialization and logging helpers, the port of the JAX package's
`utils/io.py` (reference `util/slio.py`: json / pickle / yaml by extension;
`setup_logger`, `train_multidatasets.py:55-65`, a log file per rank)."""

from __future__ import annotations

import json
import logging
import os
import pickle
import sys
from typing import Any, Optional


def load(path: str) -> Any:
    """A `.json`, `.pkl` / `.pickle` or `.yaml` / `.yml` file's content."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path) as f:
            return json.load(f)
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if ext in (".yaml", ".yml"):
        import yaml  # an optional dependency

        with open(path) as f:
            return yaml.safe_load(f)
    raise ValueError(f"unsupported extension {ext!r}")


def dump(obj: Any, path: str) -> None:
    """Write `obj` in the format of `path`'s extension, making its folder."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path, "w") as f:
            json.dump(obj, f, indent=2, default=str)
    elif ext in (".pkl", ".pickle"):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    elif ext in (".yaml", ".yml"):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(obj, f)
    else:
        raise ValueError(f"unsupported extension {ext!r}")


def setup_logger(output_dir: Optional[str] = None, name: str = "ziragroundingdino_torch",
                 rank: int = 0, level: int = logging.INFO) -> logging.Logger:
    """The package's logger: rank 0 writes to the console, and with
    `output_dir` every rank to its own file there, `log.txt` for rank 0 and
    `log.rank{r}.txt` for rank r. The handlers of an earlier call are
    replaced (the JAX package's keeps the first call's)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    for h in [h for h in logger.handlers if getattr(h, "_setup_logger", False)]:
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%m/%d %H:%M:%S")
    handlers = []
    if rank == 0:
        handlers.append(logging.StreamHandler(sys.stdout))
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        suffix = f".rank{rank}" if rank else ""
        handlers.append(logging.FileHandler(os.path.join(output_dir, f"log{suffix}.txt")))
    for h in handlers:
        h.setFormatter(fmt)
        h._setup_logger = True
        logger.addHandler(h)
    return logger
