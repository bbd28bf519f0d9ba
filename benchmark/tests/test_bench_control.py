"""The control: the plain reference computed in fp8 where the configuration
states bf16, put in the program's place, has to come out not correct under
each cell's limits. Here at the tiny configuration on the CPU; at the
cell's own size on the card (`cuda`; `benchmark/control.py` is the same
reading for several seeds)."""

import json
from pathlib import Path

import pytest
import torch

import benchmark.control as control
from benchmark.lib import check, weights
from benchmark.reference.model import RefConfig, state_shapes
from benchmark.tests.tiny import tiny_config, tiny_mix

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w for w in MANIFEST["workloads"]]


def limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())["limits"]


def control_reading(conf, mix, cell, seed, device):
    shapes = state_shapes(RefConfig.from_file(conf))
    run = control.control_run(cell, conf, mix, seed, device)
    return check.control_numbers(run, lambda: weights.make_state_dict(shapes, seed, device))


def fails(numbers, lim):
    return any(numbers[k] > lim[k] for k in numbers if k in lim)


@pytest.mark.parametrize("w", [w for w in CELLS if w["config"] == "zira-t"],
                         ids=lambda w: w["name"])
def test_control_is_not_correct_tiny(w):
    numbers = control_reading(tiny_config(w["config"]), tiny_mix(w["traffic"]), w, 2**31 + 77,
                              torch.device("cpu"))
    assert fails(numbers, limits(w["name"])), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("w", CELLS, ids=lambda w: w["name"])
def test_control_is_not_correct_on_the_card(w, cuda_device):
    conf = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    numbers = control_reading(conf, mix, w, 2**31 + 78, cuda_device)
    assert fails(numbers, limits(w["name"])), numbers
