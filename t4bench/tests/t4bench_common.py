"""Small cells in a copy of the benchmark, and the checks that every
cell and metric of a checkout meets, for the tests.  A check takes the
root of a checkout, so that a test can run it on a copy with a cell or a
metric added as files alone."""

import ast
import glob
import importlib.util
import json
import os
import re
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Traffic small enough for the port's CPU modes.
TINY = {
    "bulk-se": {"reads_per_sample": 4000, "receptor_share": 0.25,
                "clones": 20, "pool": 2},
    "bulk-pe": {"fragments_per_sample": 2000, "receptor_share": 0.25,
                "clones": 20, "pool": 2},
    "sc-10x-5p": {"cells_per_sample": 30, "receptor_share": 0.5,
                  "clonotypes": 12, "reads_per_chain": [10, 35],
                  "pool": 2},
}


def copy_bench(tmp: str) -> str:
    """BENCHMARK.json and t4bench/ copied into ``tmp``; returns the copy's
    root."""
    root = os.path.join(tmp, "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "t4bench"),
                    os.path.join(root, "t4bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def add_cell(root: str, config: str, traffic: str, mix: dict,
             limits: dict) -> str:
    """A cell ``<config>.<traffic>`` added as data files alone; returns
    its name."""
    name = f"{config}.{traffic}"
    with open(os.path.join(root, "t4bench", "traffic",
                           traffic + ".json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "t4bench", "workloads",
                           name + ".json"), "w") as f:
        json.dump({"limits": limits}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    if config not in [c["name"] for c in bench["configs"]]:
        with open(os.path.join(root, "t4bench", "configs",
                               config + ".json")) as f:
            cfg = json.load(f)
        bench["configs"].append({
            "name": config, "source": cfg["source"],
            "file": f"t4bench/configs/{config}.json",
            "reduced": cfg["reduced"], "why": "a test's configuration"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)
    return name


def bench_limits(cell: str = "bulk-se.receptor-rich") -> dict:
    """A cell's limits in the benchmark: the tiny cells of every
    configuration are held to the rich bulk cell's."""
    with open(os.path.join(ROOT, "t4bench", "workloads",
                           cell + ".json")) as f:
        return json.load(f)["limits"]


def tiny_cell(tmp: str, config: str, limits: dict):
    from t4bench.run import Cell

    root = copy_bench(tmp)
    name = add_cell(root, config, "tiny", TINY[config], limits)
    return Cell(name, root=root)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# The cells of the accepted benchmark in their order; a cell added later
# comes after them.
LISTED = ["bulk-se.receptor-rich", "sc-10x-5p.vdj",
          "bulk-se.receptor-sparse", "sc-10x-5p.gex"]
MAX_CELLS = 24


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def check_benchmark(root: str = ROOT) -> None:
    """BENCHMARK.json at ``root`` and the configuration files it names
    are of the benchmark's shape; an AssertionError names what is not."""
    b = load_bench(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["t4bench"]
    assert b["command"][:3] == ["python3", "-m", "t4bench.run"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names)), names
    assert all(NAME.match(n) for n in names), names
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace"), m
        assert 0.01 <= m["bound"] <= 0.25, m
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}, m
    cells = [w["name"] for w in b["workloads"]]
    listed = [c for c in LISTED if c in cells]
    assert cells[:len(listed)] == listed, cells
    assert cells[0] == LISTED[0], cells
    assert len(cells) <= MAX_CELLS, len(cells)
    four = [w["name"] for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four
    assert {c["name"] for c in b["configs"]} == {
        w["config"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200, w
    for c in b["configs"]:
        assert os.path.exists(os.path.join(root, c["file"])), c
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"], c
    assert len(json.dumps(b)) < 64 * 1024


def metric_names(root: str = ROOT) -> list:
    b = load_bench(root)
    return [m["name"] for m in b["end_to_end"] + b["per_layer"]]


def metric_expectations(root: str = ROOT) -> dict:
    """name -> (record, want): the ``METRICS`` of every
    ``t4bench/tests/test_t4bench_*.py`` at ``root`` that defines them, each
    a function that returns a recorded run and what the metric's reader
    reads on it.  A test module of a metric added later defines its own."""
    out = {}
    pattern = os.path.join(root, "t4bench", "tests", "test_t4bench_*.py")
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            if not _defines(ast.parse(f.read()), "METRICS"):
                continue
        spec = importlib.util.spec_from_file_location(
            "t4bench_expect_" + os.path.basename(path)[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name, expected in mod.METRICS.items():
            assert name not in out, f"{name} expected in two test modules"
            out[name] = expected
    return out


def _defines(module: ast.Module, name: str) -> bool:
    return any(isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == name for t in node.targets)
               for node in module.body)


def check_metrics(root: str = ROOT) -> None:
    """Every metric of BENCHMARK.json at ``root`` has a reader under
    ``t4bench/metrics/`` and an expectation in a test module, and each
    reader reads what its expectation wants on its recorded run."""
    from t4bench.run import Cell

    names = metric_names(root)
    expected = metric_expectations(root)
    assert sorted(names) == sorted(expected)
    cell = Cell(load_bench(root)["workloads"][0]["name"], root=root)
    for name in names:
        assert os.path.exists(os.path.join(root, "t4bench", "metrics",
                                           name + ".py")), name
        record, want = expected[name]
        assert cell.reader(name)(record()) == pytest.approx(want), name
