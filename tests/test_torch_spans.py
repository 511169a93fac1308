"""The port's span recorder (trust4_tpu_torch/utils/spans.py) on the CPU.

A child process runs ``run_trust4`` three times on the first 50 pairs of
the gold reads, from extraction on, in the shipping mode with
``device="cpu"`` (the collect path through the plain PyTorch DP): twice
with TRUST4_TPU_STAGE_TIMES=1 and once without.  Each run's stderr, the
spans it left in the store and gap_oracle.STATS are held here:

- with the switch off, no ``[stage-time]`` line and an empty store;
- the lines of the stages and sub-stages keep their names, indentation
  and order;
- every span's parent encloses it, and the two calls are samples 1 and 2;
- extraction's children on the calling thread add up to ``extract``,
  and the gap path's spans lie inside the two batches;
- STATS ``band_cells`` is counted while recording, and only then.

Besides: the recorder alone reads the switch, and ``dp_counts.band_cells``
equals the row-by-row count it stands for.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_boot_common import DATA, REPO

PAIRS = 50

CHILD = r"""
import contextlib, io, json, os, sys
from trust4_tpu_torch.ops import gap_oracle
from trust4_tpu_torch.pipeline.run import run_trust4
from trust4_tpu_torch.utils import spans

refs, reads, work = json.loads(sys.argv[1])
out = []
for k, on in enumerate((True, True, False)):
    if on:
        os.environ["TRUST4_TPU_STAGE_TIMES"] = "1"
    else:
        os.environ.pop("TRUST4_TPU_STAGE_TIMES", None)
    gap_oracle.reset_stats()
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        run_trust4(refs[0], refs[1], read1_files=[reads[0]],
                   read2_files=[reads[1]],
                   output_prefix=os.path.join(work, f"r{k}"), threads=2,
                   device="cpu")
    gap_oracle.wait_ready("cpu")  # the boot's spans are stored by now
    out.append({"stderr": buf.getvalue(),
                "spans": [r._asdict() for r in spans.drain()],
                "stats": json.loads(json.dumps(gap_oracle.STATS))})
print(json.dumps(out))
"""

# The parent commit's stage lines for this run, in order: (indent, name).
BEFORE = [
    (0, "extract"), (2, "asm/ingest"), (4, "prep/stats_trim"),
    (4, "prep/sort"), (4, "prep/annotate0"), (4, "prep/germ_trim"),
    (2, "asm/prepare"), (4, "loop/marshal"), (2, "asm/loop"),
    (0, "assemble"), (2, "ann/load"), (4, "ann/precompute"),
    (4, "ann/decide"), (2, "ann/annotate"), (2, "ann/writers"),
    (4, "realign/clean"), (4, "realign/parse_fa"), (4, "realign/assign"),
    (4, "realign/collect"), (4, "realign/em"), (4, "realign/write"),
    (2, "ann/realign"), (0, "annotate"), (0, "report"),
]
NEW = {"extract/prepare", "extract/read", "extract/filter", "extract/write",
       "extract/release", "extract/read_wait", "gaps/collect", "gaps/oracle",
       "gaps/consume"}
_LINE = re.compile(r"^\[stage-time\] ( *)(\S+): [0-9.]+s$")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from trust4_tpu_torch import testing

    d = str(tmp_path_factory.mktemp("spans"))
    refs = testing.write_standin_references(os.path.join(d, "ref"))
    reads = []
    for m in (1, 2):
        with open(os.path.join(DATA, f"gold_toassemble_{m}.fq")) as f:
            lines = f.readlines()[: 4 * PAIRS]
        reads.append(os.path.join(d, f"r{m}.fq"))
        with open(reads[-1], "w") as f:
            f.writelines(lines)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("TRUST4_TPU_DEVICE", "TRUST4_TPU_DEVICE_CHECK",
              "TRUST4_TPU_GAP_MESH", "TRUST4_TPU_GAP_TEST", "T4_PROF",
              "TRUST4_TPU_STAGE_TIMES"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps([refs, reads, d])],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _lines(run):
    return [(len(m.group(1)), m.group(2)) for m in
            map(_LINE.match, run["stderr"].splitlines()) if m]


def _by_name(run, name):
    return [s for s in run["spans"] if s["name"] == name]


def test_the_switch_off_prints_and_stores_nothing(runs):
    off = runs[2]
    assert "[stage-time]" not in off["stderr"]
    assert "[boot]" not in off["stderr"]
    assert off["spans"] == []
    assert off["stats"]["band_cells"] == [[], [], []]
    assert "TRUST4 finishes." in off["stderr"]


@pytest.mark.parametrize("k", [0, 1])
def test_the_stage_lines_keep_their_names_and_order(runs, k):
    got = _lines(runs[k])
    assert [x for x in got if x[1] not in NEW] == BEFORE
    assert [n for i, n in got if i == 0] == ["extract", "assemble",
                                             "annotate", "report"]
    new = {n: i for i, n in got if n in NEW}
    assert new == {"extract/prepare": 2, "extract/read": 2,
                   "extract/filter": 2, "extract/write": 2,
                   "extract/release": 2, "extract/read_wait": 2,
                   "gaps/collect": 6,
                   "gaps/oracle": 6, "gaps/consume": 6}
    # Every span with a line printed one, at its close.
    printed = [s for s in runs[k]["spans"] if s["thread"] == "MainThread"
               and s["name"] != "run"]
    assert sorted(s["name"] for s in printed) == sorted(n for _i, n in got)


def test_every_parent_encloses_its_spans(runs):
    for run in runs[:2]:
        by_id = {s["id"]: s for s in run["spans"]}
        for s in run["spans"]:
            if s["parent"] is None:
                assert s["name"] in ("run", "boot/import"), s
                continue
            p = by_id[s["parent"]]
            assert p["thread"] == s["thread"]
            if s["start_ns"] is None:  # a counter: inside its parent
                assert s["ns"] <= p["ns"]
                continue
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"], (p["name"], s["name"])


def test_two_calls_are_samples_one_and_two(runs):
    for k in (0, 1):
        assert {s["sample"] for s in runs[k]["spans"]} == {k + 1}
    roots = [s for r in runs[:2] for s in r["spans"] if s["name"] == "run"]
    assert [s["sample"] for s in roots] == [1, 2]
    boot = [s for r in runs for s in r["spans"] if s["name"] == "boot/import"]
    assert len(boot) == 1 and boot[0]["sample"] == 1
    assert boot[0]["thread"] == "trust4-gap-prewarm-cpu"


def test_extractions_children_add_up(runs):
    """In the second call: in the first, the boot thread imports torch
    beside extraction and can hold the GIL for 100 ms and more at a time
    (a library's load), which stalls the code between the spans.  The
    parts are the calling thread's: the native stream's reader thread
    reads beside the filter, and the caller's wait for it is
    ``extract/read_wait``."""
    run = runs[1]
    (ext,) = _by_name(run, "extract")
    parts = sum(_by_name(run, "extract/" + p)[0]["ns"] for p in
                ("prepare", "read_wait", "filter", "write", "release"))
    assert abs(parts - ext["ns"]) <= 0.05 * ext["ns"], (parts, ext["ns"])
    assert _by_name(run, "extract/read")[0]["ns"] <= ext["ns"]


@pytest.mark.parametrize("k", [0, 1])
def test_the_gap_spans_lie_inside_the_two_batches(runs, k):
    run = runs[k]
    batches = _by_name(run, "prep/annotate0") + _by_name(run,
                                                         "ann/precompute")
    assert len(batches) == 2
    for b in batches:
        kids = [s for s in run["spans"] if s["parent"] == b["id"]]
        assert [s["name"] for s in kids] == ["gaps/collect", "gaps/oracle",
                                             "gaps/consume"]
        for s in kids:
            assert b["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= b["end_ns"]
    assert len(_by_name(run, "gaps/oracle")) == 2


def test_band_cells_are_counted_while_recording(runs):
    for run in runs[:2]:
        cells = run["stats"]["band_cells"]
        assert len(cells) == 3 and sum(map(sum, cells)) > 0
        assert all(c > 0 for tier in cells for c in tier)
        assert sum(map(len, cells)) >= 2  # a launch a batch at least


def test_only_the_recorder_reads_the_switch():
    read = re.compile(r"(environ\.get|getenv|environ\[)\(?\s*"
                      r"[\"']TRUST4_TPU_STAGE_TIMES")
    pkg = os.path.join(REPO, "trust4_tpu_torch")
    found = []
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cpp", ".inc", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path, errors="replace") as fh:
                    text = fh.read()
                if read.search(text) or "T4X_PROF" in text \
                        or "t4xprof" in text or "t4a_prof_dump2" in text \
                        or "check_s" in text or "[t4prof]" in text \
                        or re.search(r"t4o_prof_dump\(", text):
                    found.append(os.path.relpath(path, REPO))
    assert found == []
    with open(os.path.join(pkg, "utils", "spans.py")) as fh:
        assert 'os.environ.get(SWITCH, "0")' in fh.read()


def _band_cells_by_row(t_lens, p_lens, w, p_max):
    """The count row by row, job by job, as its docstring states it."""
    total = 0
    for tl, pl in zip(t_lens.tolist(), p_lens.tolist()):
        left, right = 5 + max(0, pl - tl), 5 + max(0, tl - pl)
        if not 0 <= tl - pl + left < w:
            continue
        for i in range(1, min(pl, p_max) + 1):
            lo = max(1, i - left)
            hi = min(tl, i + right, i - left + w - 1)
            total += max(0, hi - lo + 1)
    return total


@pytest.mark.parametrize("cap,w", [(16, 16), (48, 24), (144, 48)])
def test_band_cells_count_row_by_row(cap, w):
    from trust4_tpu_torch.ops.dp_counts import band_cells

    rng = np.random.default_rng(cap)
    for n in (0, 1, 300):
        tl = rng.integers(0, cap + 1, n).astype(np.int32)
        pl = np.clip(tl + rng.integers(-w, w + 1, n), 0, cap).astype(np.int32)
        assert band_cells(tl, pl, w, cap) == _band_cells_by_row(tl, pl, w,
                                                                cap)


def test_the_recorder_in_process(monkeypatch, capsys):
    """Laps take their names at their end; a lap left open is dropped and
    its spans go to its parent; the switch is read when a call opens."""
    from trust4_tpu_torch.utils import spans

    spans.drain()
    monkeypatch.delenv("TRUST4_TPU_STAGE_TIMES", raising=False)
    with spans.run():
        assert spans.span("x") is spans.laps() is spans.span("y")
        spans.counter("z", 5)
    assert spans.drain() == []
    monkeypatch.setenv("TRUST4_TPU_STAGE_TIMES", "1")
    with spans.run():
        n = spans.sample()
        with spans.span("outer"):
            step = spans.laps()
            step.lap("one")
            with spans.span("inner"):
                pass
        spans.counter("total", 2_500_000_000)
    assert not spans.on()
    recs = {r.name: r for r in spans.drain()}
    assert set(recs) == {"run", "outer", "one", "inner", "total"}
    assert {r.sample for r in recs.values()} == {n}
    assert recs["inner"].parent == recs["outer"].id  # not the dropped lap
    assert recs["one"].parent == recs["outer"].id
    assert recs["total"].parent == recs["run"].id
    assert recs["total"].start_ns is None and recs["total"].ns == 2500000000
    err = [x.split(": ")[0] for x in capsys.readouterr().err.splitlines()]
    # "inner" opened inside the lap that was then dropped: its line has
    # the lap's depth.
    assert err == ["[stage-time]   one", "[stage-time]     inner",
                   "[stage-time] outer", "[stage-time] total"]
