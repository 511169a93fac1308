"""The span readers (``t4bench/span_lines.py`` and their metrics) on a
recorded run: the program's ``[stage-time]`` lines at every depth,
gap_oracle.STATS ``band_cells`` and the ``[boot]`` line's phases; None
with tracing off and from a program that records none of them."""

import pytest

from t4bench import readers
from t4bench.run import Cell

STDERR = """\
Start to extract candidate reads.
[stage-time]   extract/prepare: 0.120s
[stage-time]   extract/read: 0.900s
[stage-time]   extract/filter: 2.100s
[stage-time]   extract/write: 0.010s
[stage-time]   extract/release: 0.030s
[stage-time] extract: 3.170s
[stage-time]   asm/ingest: 0.058s
[stage-time]       gaps/collect: 0.210s
[stage-time]       gaps/oracle: 0.050s
[stage-time]       gaps/consume: 0.150s
[stage-time]     prep/annotate0: 0.420s
[stage-time]   asm/prepare: 0.500s
[stage-time]   asm/loop: 0.250s
[stage-time] assemble: 0.983s
[stage-time]       gaps/collect: 0.300s
[stage-time]       gaps/oracle: 0.020s
[stage-time]       gaps/consume: 0.250s
[stage-time]     ann/precompute: 0.580s
[stage-time]   ann/annotate: 0.600s
[stage-time]   ann/realign: 0.125s
[stage-time] annotate: 0.851s
[stage-time] report: 0.021s
[boot] torch_loaded_by=trust4-gap-prewarm-cuda:0 import_s=9.952 \
ready_wait_s=5.781 context_s=0.400 load_s=0.150 warm_s=0.050
TRUST4 finishes."""

# The parent commit's boot line, and its STATS: no phases, no band cells.
OLD_BOOT = ("[boot] torch_loaded_by=trust4-gap-prewarm-cuda:0 import_s=9.952 "
            "ready_wait_s=5.781")


def _record(trace=True, program="new"):
    lines = [(float(i), x) for i, x in enumerate(STDERR.split("\n"))]
    second = [(t, x.replace("0.900", "1.100").replace("0.300", "0.500"))
              for t, x in lines]
    stats = [{"band_cells": [[100, 200], [300], [400]]},
             {"band_cells": [[100], [300], [1000, 200]]}]
    if not trace:
        lines = second = []
        stats = [{"band_cells": [[], [], []]}] * 2
    if program == "old":
        stats = [{}, {}]
    boot = STDERR.split("\n")[-2] if program == "new" else OLD_BOOT
    return {"cold_s": 12.5, "setup_s": 16.9, "window_s": 4.0,
            "boot_line": boot if trace else "",
            "samples": [{"stderr": lines, "n_reads": 100000,
                         "stats": stats[0]},
                        {"stderr": second, "n_reads": 100000,
                         "stats": stats[1]}],
            "trace": None}


WANT = {
    "extract.read_s_per_sample": 1.0,
    "extract.filter_s_per_sample": 2.1,
    "assemble.loop_s_per_sample": 0.25,
    "annotate.realign_s_per_sample": 0.125,
    "gap_oracle.collect_s_per_sample": 0.61,
    "gap_oracle.consume_s_per_sample": 0.4,
    "dp_counts.band_cells_per_sample": 1300.0,
    "boot.device_init_s": 0.6,
}
METRICS = {name: (_record, want) for name, want in WANT.items()}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    cell = Cell("bulk-se.receptor-sparse")
    assert cell.reader(name)(_record()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_without_tracing(name):
    cell = Cell("bulk-se.receptor-sparse")
    assert cell.reader(name)(_record(trace=False)) is None


# Lines the parent commit printed already: read there too.
OLD_LINES = {"assemble.loop_s_per_sample", "annotate.realign_s_per_sample"}
NEW_SPANS = ("extract/", "gaps/")


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_the_spans(name):
    """The parent commit's run: no extraction phases, no gap spans, no
    band cells, no boot phases; its sub-stage lines as here."""
    rec = _record(program="old")
    for s in rec["samples"]:
        s["stderr"] = [(t, x) for t, x in s["stderr"]
                       if not any(n in x for n in NEW_SPANS)]
    got = Cell("bulk-se.receptor-rich").reader(name)(rec)
    if name in OLD_LINES:
        assert got == pytest.approx(WANT[name])
    else:
        assert got is None


def test_the_extended_boot_line_reads_as_before():
    line = STDERR.split("\n")[-2]
    assert readers._BOOT.match(line)
    assert readers.boot({"boot_line": line}) == (9.952, 5.781)
    assert readers.boot({"boot_line": OLD_BOOT}) == (9.952, 5.781)
    assert readers.stages(_record()["samples"][0]) == {
        "extract": 3.17, "assemble": 0.983, "annotate": 0.851,
        "report": 0.021}


def test_every_new_metric_is_in_both_cells():
    for cell in ("bulk-se.receptor-rich", "bulk-se.receptor-sparse"):
        names = {m["name"] for m in Cell(cell).per_layer}
        assert set(WANT) <= names
