"""The harness driven on the CPU: it refuses to run without a card; with
the look for a card skipped and the program in a CPU mode, a sound run
is correct and a run with the timed path broken underneath is not."""

import gzip
import json
import os
import subprocess
import sys

import pytest

from t4bench import run
from t4bench.reference import judge
from t4bench_common import ROOT, bench_limits, tiny_cell

# The limits of the tiny cells: the rich bulk cell's.
CONFIGS = ("bulk-se", "bulk-pe", "sc-10x-5p")
LIMITS = {c: bench_limits() for c in CONFIGS}


def test_exits_nonzero_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "t4bench.run", "--workload",
         "bulk-se.receptor-rich", "--seed", "4000000001", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "t4bench:" in out.stderr


def test_exits_nonzero_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and t4bench/."""
    from t4bench_common import copy_bench

    root = copy_bench(str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "t4bench.run", "--workload",
         "bulk-se.receptor-rich", "--seed", "4000000002", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_card_check_after_the_cold_sample(tmp_path):
    """With the kernel build skipped, the cold sample reaches the card
    and the run stops at the look for it."""
    code = (
        "import sys; sys.path.insert(0, 't4bench/tests')\n"
        "from t4bench_common import ROOT, tiny_cell\n"
        "from t4bench import run\n"
        f"cell = tiny_cell({str(tmp_path)!r}, 'bulk-se', {{}})\n"
        "try:\n"
        "    run.run_cell(cell, 3, 1, False, compile_kernels=False)\n"
        "except run.HarnessError as e:\n"
        "    print('refused:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "refused: torch.cuda.is_available() is False" in out.stdout, \
        out.stderr[-3000:]


def _cpu_run(tmp_path, config, wrap=None, seed=2 ** 31 + 5):
    cell = tiny_cell(str(tmp_path), config, LIMITS[config])
    return run.run_cell(cell, seed, 0.5, False, device="cpu",
                        compile_kernels=False, wrap=wrap)


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(tmp_path, monkeypatch, config):
    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    r = _cpu_run(tmp_path, config)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(r)[-4:] == ["checks", "_error", "_walls", "_phases"]


def test_phases_of_a_run(tmp_path, monkeypatch, capfd):
    """``run_cell`` returns the walls of the run's phases, which add up to
    its total; ``main`` prints them, then the sample walls, and ends
    standard error with the check lines."""
    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    cell = tiny_cell(str(tmp_path), "bulk-se", LIMITS["bulk-se"])
    real = run.run_cell
    phases = {}

    def on_the_cpu(c, seed, seconds, trace):
        r = real(c, seed, seconds, trace, device="cpu",
                 compile_kernels=False)
        phases.update(r["_phases"])
        return r

    # The test's process keeps its own fault handler.
    monkeypatch.setattr(run.faulthandler, "enable", lambda: None)
    monkeypatch.setattr(run, "Cell", lambda name: cell)
    monkeypatch.setattr(run, "run_cell", on_the_cpu)
    rc = run.main(["--workload", cell.name, "--seed", str(2 ** 33 + 7),
                   "--seconds", "0.5", "--trace", "0"])
    out, err = capfd.readouterr()
    assert rc == 0, err[-3000:]
    assert list(phases) == list(run.PHASES) + ["total"]
    assert min(phases.values()) >= 0
    assert abs(sum(phases[k] for k in run.PHASES) - phases["total"]) < 1
    lines = err.rstrip("\n").split("\n")
    n = len(judge.NUMBERS)
    assert [x.split()[1] for x in lines[-n:]] == list(judge.NUMBERS)
    assert all(x.startswith("check ") for x in lines[-n:])
    assert lines[-n - 1].startswith("sample walls (s): ")
    assert lines[-n - 2].split()[2::2] == list(run.PHASES) + ["total"]
    assert lines[-n - 2].startswith("phases (s): ")
    result = json.loads(out.rstrip("\n").split("\n")[-1])
    assert list(result)[-1] == "checks" and result["correct"]


def _unchanged(fn):
    """A step that returns its state unchanged: nothing is run."""
    def step(*a, **k):
        return None
    return step


def _half(fn):
    """Half of the batch left out: the sample's first half of reads."""
    def step(coord, imgt, **kw):
        for key in ("single_files", "barcode_files", "read1_files",
                    "read2_files"):
            if kw.get(key):
                src = kw[key][0]
                dst = os.path.join(os.path.dirname(kw["output_prefix"]),
                                   os.path.basename(src))
                with gzip.open(src, "rt") as f:
                    lines = f.read().split("\n")
                n = len(lines) // 4
                with gzip.open(dst, "wt") as f:
                    f.write("\n".join(lines[:4 * (n // 2)]) + "\n")
                kw[key] = [dst]
        return fn(coord, imgt, **kw)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half],
                         ids=["unchanged", "half"])
@pytest.mark.parametrize("config", CONFIGS)
def test_fault_is_not_correct(tmp_path, monkeypatch, config, fault):
    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    r = _cpu_run(tmp_path, config, wrap=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("config", CONFIGS)
def test_altered_cdr3_is_not_correct(tmp_path, monkeypatch, config):
    """An answer altered where it is produced: the annotator writes each
    CDR3 with its fourth base changed."""
    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    from trust4_tpu_torch.pipeline.annotator import Annotator

    real = Annotator.realign_and_write_cdr3

    def altered(self, reads_path, cdr3_path, *a, **k):
        real(self, reads_path, cdr3_path, *a, **k)
        with open(cdr3_path) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        with open(cdr3_path, "w") as f:
            for r in rows:
                if len(r) > 8 and len(r[8]) > 3:
                    r[8] = r[8][:3] + "ACGTA"["ACGT".find(r[8][3]) + 1] \
                        + r[8][4:]
                f.write("\t".join(r) + "\n")

    monkeypatch.setattr(Annotator, "realign_and_write_cdr3", altered)
    r = _cpu_run(tmp_path, config)
    assert not r["correct"], r["checks"]


def _mate_two_dropped(fn):
    """Every record of ``_toassemble_2.fq`` dropped once the program has
    written it."""
    def step(coord, imgt, **kw):
        fn(coord, imgt, **kw)
        open(kw["output_prefix"] + "_toassemble_2.fq", "w").close()
    return step


def test_dropped_mate_two_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("TRUST4_TPU_DEVICE", "0")
    r = _cpu_run(tmp_path, "bulk-pe", wrap=_mate_two_dropped)
    assert not r["correct"], r["checks"]
    missed = r["checks"]["extract_missed"]
    assert missed["value"] > missed["limit"], r["checks"]
