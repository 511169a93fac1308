"""BENCHMARK.json and the files its names point to: a cell added as data
files alone is found by its name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from t4bench.reference import judge
from t4bench.run import Cell, HarnessError
from t4bench_common import (LISTED, MAX_CELLS, ROOT, add_cell, bench_limits,
                            check_benchmark, check_metrics, copy_bench,
                            load_bench)


def test_shape_of_benchmark_json(tmp_path):
    check_benchmark(ROOT)
    check_benchmark(copy_bench(str(tmp_path)))


@pytest.mark.parametrize("name",
                         [w["name"] for w in load_bench()["workloads"]])
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


# The rich paired-end mix that a bulk-pe cell would run, and a per-layer
# metric of its mate extension, each as the files a later change adds.
PAIRS_RICH = {"fragments_per_sample": 200000, "receptor_share": 0.05,
              "clones": 500, "pool": 3}
MATE_METRIC = "assemble.mate_s_per_sample"
MATE_FILES = {
    f"metrics/{MATE_METRIC}.py": '''"""Mate extension per sample."""

from t4bench.span_lines import mean_span


def read(record):
    return mean_span(record, "asm/mate")
''',
    "tests/test_t4bench_mate.py": '''"""The mate extension's reader on a recorded run."""


def _record():
    lines = [[(0.0, "[stage-time]   asm/mate: %.3fs" % s)] for s in (1, 2)]
    return {"samples": [{"stderr": x, "n_reads": 10, "stats": {}}
                        for x in lines]}


METRICS = {"assemble.mate_s_per_sample": (_record, 1.5)}


def test_reader_reads_the_span():
    from t4bench.run import Cell

    record, want = METRICS["assemble.mate_s_per_sample"]
    cell = Cell("bulk-pe.pairs-rich")
    assert cell.reader("assemble.mate_s_per_sample")(record()) == want
''',
}


def test_cell_added_as_data_passes_every_check(tmp_path):
    """A bulk-pe cell and a per-layer metric of its own go into a copy as
    new files and new entries of BENCHMARK.json alone; the checks of
    every cell and metric, and the tests that name cells and metrics, then
    pass on the copy."""
    root = copy_bench(str(tmp_path))
    shutil.copytree(os.path.join(ROOT, "t4bench", "tests"),
                    os.path.join(root, "t4bench", "tests"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = add_cell(root, "bulk-pe", "pairs-rich", PAIRS_RICH,
                    bench_limits())
    for rel, text in MATE_FILES.items():
        path = os.path.join(root, "t4bench", rel)
        assert not os.path.exists(path)
        with open(path, "w") as f:
            f.write(text)
    bench = load_bench(root)
    bench["per_layer"].append({
        "name": MATE_METRIC, "unit": "s", "better": "lower",
        "source": "program_span", "layer": "assembly",
        "moves": "reads_per_s", "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    check_benchmark(root)
    check_metrics(root)
    cell = Cell(name, root=root)
    assert cell.config["layout"] == "bulk-pe"
    assert MATE_METRIC in {m["name"] for m in cell.per_layer}
    tests = os.path.join(root, "t4bench", "tests")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-k", "not passes_every_check and not shape_check_refuses",
         os.path.join(tests, "test_t4bench_cells.py"),
         os.path.join(tests, "test_t4bench_metrics.py"),
         os.path.join(tests, "test_t4bench_mate.py")],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for test in (f"test_reader[{MATE_METRIC}]",
                 f"test_every_cell_has_its_files[{name}]",
                 "test_every_metric_has_a_reader",
                 "test_shape_of_benchmark_json",
                 "test_reader_reads_the_span"):
        assert f"{test} PASSED" in out.stdout, out.stdout[-3000:]


def _many_cells(root, n):
    """Cells added to the copy at ``root`` until it holds ``n``."""
    mix = {"reads_per_sample": 1000, "receptor_share": 0.1, "clones": 5,
           "pool": 2}
    while len(load_bench(root)["workloads"]) < n:
        add_cell(root, "bulk-se", f"t{len(load_bench(root)['workloads'])}",
                 mix, {k: 1 for k in judge.NUMBERS})


def _set_chips(root, four):
    bench = load_bench(root)
    for w in bench["workloads"]:
        w["chips"] = 4 if w["name"] in four else 1
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def _move_last_cell_to(root, at):
    bench = load_bench(root)
    bench["workloads"].insert(at, bench["workloads"].pop())
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.mark.parametrize("case", ["fifth_four_chip_cell", "cell_25",
                                  "new_cell_first", "new_cell_between"])
def test_shape_check_refuses(tmp_path, case):
    """The shape check takes the most that its rules allow, and refuses
    one more: a fifth cell on four chips of 16 (four pass), a 25th cell
    (24 pass), or a new cell before a listed one."""
    root = copy_bench(str(tmp_path))
    if case == "fifth_four_chip_cell":
        _many_cells(root, 16)
        cells = [w["name"] for w in load_bench(root)["workloads"]]
        _set_chips(root, cells[-4:])
        check_benchmark(root)
        _set_chips(root, cells[-5:])
    elif case == "cell_25":
        _many_cells(root, MAX_CELLS)
        check_benchmark(root)
        _many_cells(root, MAX_CELLS + 1)
    else:
        _many_cells(root, len(load_bench(root)["workloads"]) + 1)
        check_benchmark(root)
        listed = [w["name"] for w in load_bench(root)["workloads"]
                  if w["name"] in LISTED]
        _move_last_cell_to(root, 0 if case == "new_cell_first"
                           else len(listed) - 1)
    with pytest.raises(AssertionError):
        check_benchmark(root)
