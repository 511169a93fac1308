"""``extract.read_wait_s_per_sample`` on recorded stage lines: the mean
over the window's samples of the program's ``extract/read_wait``
counter; None with tracing off and from a program whose stream prints no
such counter (its read and filter phases add up instead)."""

import pytest

from t4bench.run import Cell

NAME = "extract.read_wait_s_per_sample"

STAGES = """\
Start to extract candidate reads.
[stage-time]   extract/prepare: 0.120s
[stage-time]   extract/read: 0.900s
[stage-time]   extract/filter: 2.100s
[stage-time]   extract/write: 0.010s
[stage-time]   extract/read_wait: 0.040s
[stage-time]   extract/release: 0.030s
[stage-time] extract: 2.300s
[stage-time] assemble: 0.983s
[stage-time] annotate: 0.851s
[stage-time] report: 0.021s
TRUST4 finishes."""


def _record(trace=True, program="new"):
    text = STAGES
    if program == "old":
        text = "\n".join(x for x in text.split("\n")
                         if "extract/read_wait" not in x)
    first = [(float(i), x) for i, x in enumerate(text.split("\n"))]
    second = [(t, x.replace("0.040", "0.080")) for t, x in first]
    if not trace:
        first = second = []
    return {"cold_s": 12.5, "setup_s": 16.9, "window_s": 4.0,
            "boot_line": "", "trace": None,
            "samples": [{"stderr": first, "n_reads": 100000, "stats": {}},
                        {"stderr": second, "n_reads": 100000,
                         "stats": {}}]}


METRICS = {NAME: (_record, 0.06)}


@pytest.mark.parametrize("cell", ["bulk-se.receptor-rich",
                                  "bulk-se.receptor-sparse"])
def test_reads_the_counter_in_both_cells(cell):
    c = Cell(cell)
    assert NAME in {m["name"] for m in c.per_layer}
    record, want = METRICS[NAME]
    assert c.reader(NAME)(record()) == pytest.approx(want)


def test_none_with_tracing_off():
    assert Cell("bulk-se.receptor-sparse").reader(NAME)(
        _record(trace=False)) is None


def test_none_from_the_parents_lines():
    cell = Cell("bulk-se.receptor-sparse")
    rec = _record(program="old")
    assert cell.reader(NAME)(rec) is None
    assert cell.reader("extract.read_s_per_sample")(rec) == pytest.approx(0.9)


def test_a_sample_without_the_counter_reads_none():
    rec = _record()
    rec["samples"][1]["stderr"] = _record(program="old")["samples"][1][
        "stderr"]
    assert Cell("bulk-se.receptor-rich").reader(NAME)(rec) is None
