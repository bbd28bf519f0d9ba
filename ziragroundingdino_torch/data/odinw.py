"""ODinW task registry: the 13/35 sub-dataset suite + shot regimes (the
port's copy of the JAX package's `data/odinw.py`).

Replaces the per-task LazyConfig files (`groundingdino/config/configs/common/
data/odinw*/…` + `test_odinw13*/for_train/*.py`): every task is a COCO json
pair under a datasets root. Schedule facts mirror the task configs: 10 epochs
x iter_per_epoch (200 full / 4 one-shot / 20 5-shot / 40 10-shot —
`test_odinw13/for_train/test_aquarium.py:5-6` and shot-dir diffs), LR drops
at 4/10 and (implicitly) end of run via `modified_coco_scheduler(10, 4)`,
batch 2, grad clip 0.1, soft-freeze lr_factor 0.2 on "freeze" params.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ziragroundingdino_torch.data.coco import CocoDataset

ANNOS = "annotations_without_background.json"

# name -> (subdir, train_split, test_split); paths cited from the odinw data
# configs (`config/configs/common/data/odinw/*.py`)
ODINW_PATHS: Dict[str, Tuple[str, str, str]] = {
    "AerialMaritimeDrone_large": ("AerialMaritimeDrone/large", "train", "test"),
    "AerialMaritimeDrone_tiled": ("AerialMaritimeDrone/tiled", "train", "test"),
    "AmericanSignLanguageLetters": (
        "AmericanSignLanguageLetters/American Sign Language Letters.v1-v1.coco",
        "train", "test"),
    "Aquarium": ("Aquarium/Aquarium Combined.v2-raw-1024.coco", "train", "test"),
    "BCCD": ("BCCD/BCCD.v4-416x416_aug.coco", "train", "test"),
    "CottontailRabbits": ("CottontailRabbits", "train", "test"),
    "EgoHands_generic": ("EgoHands/generic", "train", "test"),
    "MaskWearing": ("MaskWearing/raw", "train", "test"),
    "NorthAmericaMushrooms": (
        "NorthAmericaMushrooms/North American Mushrooms.v1-416x416.coco",
        "train", "test"),
    "Packages": ("Packages/augmented-v1", "train", "test"),
    "PascalVOC": ("PascalVOC", "train", "valid"),
    "PKLot": ("PKLot/640", "train", "test"),
    "pistols": ("pistols/export", "train", "test"),
    "pothole": ("pothole", "train", "test"),
    "Raccoon": ("Raccoon/Raccoon.v38-416x416-resize.coco", "train", "test"),
    "selfdrivingCar": ("selfdrivingCar/fixedLarge/export", "train", "test"),
    "ShellfishOpenImages": ("ShellfishOpenImages/416x416", "train", "test"),
    "thermalDogsAndPeople": ("thermalDogsAndPeople", "train", "test"),
    "VehiclesOpenImages": ("VehiclesOpenImages/416x416", "train", "test"),
}

# the 13-task suite (`test_odinw13/for_train/` listing)
ODINW13: List[str] = [
    "AerialMaritimeDrone_tiled", "Aquarium", "CottontailRabbits",
    "EgoHands_generic", "NorthAmericaMushrooms", "Packages", "PascalVOC",
    "pistols", "pothole", "Raccoon", "ShellfishOpenImages",
    "thermalDogsAndPeople", "VehiclesOpenImages",
]

# the 35-suite dirs present in the reference (`test_odinw35/for_train/`)
ODINW35: List[str] = ODINW13 + [
    "AerialMaritimeDrone_large", "AmericanSignLanguageLetters", "BCCD",
    "MaskWearing", "PKLot", "selfdrivingCar",
]

# iters/epoch by shot regime (`test_odinw13{_1shot,_5shot,_10shot}` diffs)
ITERS_PER_EPOCH = {"full": 200, "1shot": 4, "5shot": 20, "10shot": 40}
EPOCHS = 10


@dataclass
class OdinwTask:
    name: str
    train_json: str
    train_root: str
    test_json: str
    test_root: str
    iter_per_epoch: int = 200

    @property
    def max_iter(self) -> int:
        return EPOCHS * self.iter_per_epoch

    def load_train(self, **kw) -> CocoDataset:
        return CocoDataset.from_json(self.train_json, self.train_root, **kw)

    def load_test(self, **kw) -> CocoDataset:
        return CocoDataset.from_json(self.test_json, self.test_root, **kw)


def get_odinw_task(
    name: str, datasets_root: str = "datasets/odinw", shot: str = "full",
    seed: int = 3,
) -> OdinwTask:
    sub, train_split, test_split = ODINW_PATHS[name]
    base = os.path.join(datasets_root, sub)
    if shot == "full":
        train_json = os.path.join(base, train_split, ANNOS)
    else:
        # `odinw_1shot/aquarium.py:21`: fewshot_train_shot{N}_seed{S}.json
        n = shot.replace("shot", "")
        train_json = os.path.join(
            base, train_split, f"fewshot_train_shot{n}_seed{seed}.json"
        )
    return OdinwTask(
        name=name,
        train_json=train_json,
        train_root=os.path.join(base, train_split),
        test_json=os.path.join(base, test_split, ANNOS),
        test_root=os.path.join(base, test_split),
        iter_per_epoch=ITERS_PER_EPOCH[shot],
    )


def odinw_suite(
    suite: str = "odinw13", datasets_root: str = "datasets/odinw",
    shot: str = "full",
) -> List[OdinwTask]:
    names = {"odinw13": ODINW13, "odinw35": ODINW35}[suite]
    return [get_odinw_task(n, datasets_root, shot) for n in names]
