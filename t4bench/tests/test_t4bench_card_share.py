"""``extract.card_share`` on recorded counts: the mean over the window's
samples of the tests the card decided over all the bulk stream's tests;
None with tracing off (the program counts nothing) and from a program
that counts no such tests."""

import pytest

from t4bench.run import Cell

NAME = "extract.card_share"


def _record(trace=True, program="new"):
    counts = [[1_000_000, 0], [999_000, 1_000]]
    samples = []
    for c in counts:
        stats = {"gap_fills": 160000}
        if program == "new":
            stats["extract_reads"] = c if trace else [0, 0]
        samples.append({"stderr": [], "n_reads": 1_000_000, "stats": stats})
    return {"cold_s": 12.5, "setup_s": 16.9, "window_s": 4.0,
            "boot_line": "", "trace": None, "samples": samples}


METRICS = {NAME: (_record, 0.9995)}


@pytest.mark.parametrize("cell", ["bulk-se.receptor-rich",
                                  "bulk-se.receptor-sparse"])
def test_reads_the_counts_in_both_cells(cell):
    c = Cell(cell)
    assert NAME in {m["name"] for m in c.per_layer}
    record, want = METRICS[NAME]
    assert c.reader(NAME)(record()) == pytest.approx(want)


def test_none_with_tracing_off():
    assert Cell("bulk-se.receptor-sparse").reader(NAME)(
        _record(trace=False)) is None


def test_none_from_a_program_without_the_counts():
    assert Cell("bulk-se.receptor-rich").reader(NAME)(
        _record(program="old")) is None


def test_host_only_samples_read_zero():
    rec = _record()
    for s in rec["samples"]:
        s["stats"]["extract_reads"] = [0, 400_000]
    assert Cell("bulk-se.receptor-rich").reader(NAME)(rec) == 0
