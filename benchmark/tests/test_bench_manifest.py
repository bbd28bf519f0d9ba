"""BENCHMARK.json against the contract's shape rules, and the imports of
every file under benchmark/."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ziragroundingdino_tpu"}


def metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(MANIFEST["command"]) <= 32
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("entry", [m["name"] for m in metrics()]
                         + [w["name"] for w in MANIFEST["workloads"]]
                         + [c["name"] for c in MANIFEST["configs"]])
def test_names(entry):
    assert NAME.match(entry), entry


def test_names_unique():
    for group in (metrics(), MANIFEST["workloads"], MANIFEST["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", metrics(), ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])


@pytest.mark.parametrize("m", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(m):
    e2e = {x["name"]: x for x in MANIFEST["end_to_end"]}
    assert m["moves"] in e2e
    for w in MANIFEST["workloads"]:
        if reports(w["name"], m):
            assert reports(w["name"], e2e[m["moves"]]), (m["name"], w["name"])


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert w["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    reported = [m for m in metrics() if reports(w["name"], m)]
    names = {m["name"] for m in reported}
    assert "setup_s" in names
    assert any(m in MANIFEST["end_to_end"] and m["name"] != "setup_s" for m in reported)
    assert any(m in MANIFEST["per_layer"] for m in reported)
    pairs = [(x["config"], x["traffic"]) for x in MANIFEST["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    conf = json.loads((ROOT / c["file"]).read_text())
    assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"] == []
    assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def py_files():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", py_files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ziragroundingdino_torch" not in set(top_level_imports(path))


def test_limits_for_every_cell():
    for w in MANIFEST["workloads"]:
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert lim["limits"] and all(v >= 0 for v in lim["limits"].values())


def traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_a_run_kind(w):
    import importlib

    from benchmark.run import RUNS

    kind = traffic(w["traffic"])["kind"]
    assert kind in RUNS
    module, name, family = RUNS[kind]
    assert hasattr(importlib.import_module(f"benchmark.lib.{module}"), name)
    assert family in ("serve", "train")


def test_four_card_cells():
    cells = MANIFEST["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        mix = traffic(w["traffic"])
        assert mix.get("ranks", 1) in (1, w["chips"])
        if mix["kind"] == "train-ddp":
            assert mix["ranks"] == w["chips"] and mix["batch"] % mix["ranks"] == 0


def test_data_parallel_traffic_is_train_b8_split():
    """The data-parallel cell's batches are the one-card cell's."""
    one, ddp = traffic("train-b8"), traffic("train-ddp4")
    differ = {k for k in set(one) | set(ddp) if one.get(k) != ddp.get(k)}
    assert differ == {"kind", "ranks", "why", "ranks_source"}


def test_collective_readers():
    """The collectives' readers, for a data-parallel cell to name: nothing
    where no collective ran, else ms a step."""
    import types

    from benchmark.lib.trace import TraceResult
    from benchmark.run import reader

    t = TraceResult("train", items=[0, 1])
    t.kernel_s["gemm"] = 0.5
    ctx = types.SimpleNamespace(trace=t)
    for name in ("allreduce_ms.train", "allreduce_exposed_ms.train"):
        assert reader(name)(ctx) is None
    t.kernel_s["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] = 0.004
    t.collective_exposed_s = 0.001
    assert reader("allreduce_ms.train")(ctx) == pytest.approx(2.0)
    assert reader("allreduce_exposed_ms.train")(ctx) == pytest.approx(0.5)
