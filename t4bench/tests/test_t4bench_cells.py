"""BENCHMARK.json and the files its names point to: a cell added as data
files alone is found by its name."""

import json
import os
import re

import pytest

from t4bench.reference import judge
from t4bench.run import Cell, HarnessError
from t4bench_common import ROOT, add_cell, copy_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_shape_of_benchmark_json():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["t4bench"]
    assert b["command"][:3] == ["python3", "-m", "t4bench.run"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    order = ["bulk-se.receptor-rich", "sc-10x-5p.vdj",
             "bulk-se.receptor-sparse", "sc-10x-5p.gex"]
    cells = [w["name"] for w in b["workloads"]]
    assert cells == [c for c in order if c in cells]
    assert cells[0] == order[0]
    assert {c["name"] for c in b["configs"]} == {
        w["config"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_has_its_files(name):
    cell = Cell(name)
    assert set(cell.limits) == set(judge.NUMBERS)
    for name in ("generate", "run_args", "OUTPUTS", "wrong_barcodes",
                 "reported", "write_report"):
        assert hasattr(cell.layout, name)
    assert cell.mix["pool"] >= 2
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.per_layer) >= 1


def test_cell_added_as_data_is_found(tmp_path):
    root = copy_bench(str(tmp_path))
    name = add_cell(root, "bulk-se", "throwaway",
                    {"reads_per_sample": 1000, "receptor_share": 0.1,
                     "clones": 5, "pool": 2},
                    {k: 1 for k in judge.NUMBERS})
    cell = Cell(name, root=root)
    assert cell.mix["reads_per_sample"] == 1000
    assert cell.limits["clone_miss"] == 1
    assert cell.config["layout"] == "bulk-se"
    assert cell.reader("setup_s")({"setup_s": 3.0}) == 3.0
    with pytest.raises(HarnessError):
        Cell("bulk-se.not-there", root=root)


def test_layout_added_as_a_file_is_found(tmp_path):
    """A configuration whose ``layout`` names a new module under
    ``layouts/`` is run by it: no shared file names a layout."""
    import shutil

    root = copy_bench(str(tmp_path))
    lay = os.path.join(root, "t4bench", "layouts")
    shutil.copy(os.path.join(lay, "bulk-se.py"),
                os.path.join(lay, "bulk-throwaway.py"))
    cfg_dir = os.path.join(root, "t4bench", "configs")
    with open(os.path.join(cfg_dir, "bulk-se.json")) as f:
        cfg = json.load(f)
    cfg["layout"] = "bulk-throwaway"
    with open(os.path.join(cfg_dir, "bulk-throwaway.json"), "w") as f:
        json.dump(cfg, f)
    name = add_cell(root, "bulk-throwaway", "throwaway",
                    {"reads_per_sample": 1000, "receptor_share": 0.1,
                     "clones": 5, "pool": 2},
                    {k: 1 for k in judge.NUMBERS})
    cell = Cell(name, root=root)
    assert cell.layout.__file__ == os.path.join(lay, "bulk-throwaway.py")
    from t4bench.traffic import generator

    pool = generator.generate_pool(cell.config, cell.mix, 7,
                                   str(tmp_path / "pool"), cell.layout)
    assert [s["n_reads"] for s in pool] == [1000, 1000]
    assert cell.layout.run_args(pool[0]) == {
        "single_files": [pool[0]["files"]["single"]]}


def test_shared_code_names_no_layout():
    for rel in ("run.py", "reference/judge.py", "reference/control.py",
                "traffic/generator.py"):
        with open(os.path.join(ROOT, "t4bench", rel)) as f:
            text = f.read()
        for layout in os.listdir(os.path.join(ROOT, "t4bench", "layouts")):
            if layout.endswith(".py") and layout != "__init__.py":
                assert '"' + layout[:-3] + '"' not in text, (rel, layout)
