"""Small cells in a copy of the benchmark, for the tests."""

import json
import os
import shutil

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
