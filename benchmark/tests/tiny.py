"""A configuration of the benchmark's format at a size a CPU test can hold."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tiny_config(name: str = "zira-t") -> dict:
    conf = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    conf = copy.deepcopy(conf)
    conf["name"] = f"tiny-{name}"
    conf["swin"] = dict(conf["swin"], embed_dim=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8],
                        window_size=4)
    conf["bert"] = dict(conf["bert"], vocab_size=300, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    conf["model"] = dict(conf["model"], hidden_dim=64, nheads=4, dim_feedforward=128,
                         enc_layers=2, dec_layers=2, num_queries=30, max_text_len=64)
    return conf


def tiny_mix(name: str) -> dict:
    """A traffic mix of the benchmark's at sizes a CPU test can hold."""
    mix = copy.deepcopy(json.loads((ROOT / "traffic" / f"{name}.json").read_text()))
    if mix["kind"] == "serve":
        # each task's first and last photo (a request's worth of each), at
        # 200 px on the long side
        for t in mix["tasks"]:
            t["sizes"] = [[round(h * 200 / max(h, w)), round(w * 200 / max(h, w))]
                          for h, w in [t["sizes"][0]] * mix["batch"]
                          + [t["sizes"][-1]] * mix["batch"]]
        land = [[96, 128], [96, 160], [128, 160]]
        mix["data"] = {"test_short_side": 96, "max_size": 160,
                       "shape_buckets": land + [[w, h] for h, w in land]}
        mix["check"] = {"requests": 3}
        if max(t["labels"] for t in mix["tasks"]) > 20:  # every name a request: fewer names
            mix["names"] = mix["names"][:12]
            for t in mix["tasks"]:
                t["labels"] = 12
            mix["predictor"] = dict(mix["predictor"], text_len_buckets=[32, 64],
                                    category_buckets=[4, 8, 16])
    else:
        mix["photos"] = {"long_side": [200, 256], "aspect": [[4, 3], [16, 9]]}
        mix["train_short_sides"] = [64, 96]
        mix["max_size"] = 160
        mix["shape_buckets"] = [[96, 128], [96, 160], [128, 160]]
        mix["batches"] = 4
        mix["batch"] = 2
        mix["label_counts"] = {"one": 1, "two": 2, "three": 3}
        mix["boxes_per_label"] = [1, 2]
        mix["max_boxes"] = 12
        if "ranks" in mix:  # a data mesh of 2 gloo ranks, an image each
            mix["ranks"] = 2
    return mix
