"""Each metric reader on a recorded run: the program's ``[stage-time]``
and ``[boot]`` text, gap_oracle.STATS and a device trace."""

import pytest

from t4bench.run import Cell
from t4bench_common import (ROOT, check_metrics, metric_expectations,
                            metric_names)

STDERR = """\
Start to extract candidate reads.
[stage-time] extract: 0.462s
[stage-time]   asm/ingest: 0.058s
[stage-time]     prep/annotate0: 0.144s
[stage-time] assemble: 0.983s
[stage-time]   ann/load: 0.024s
[stage-time] annotate: 0.851s
[stage-time] report: 0.021s
[boot] torch_loaded_by=trust4-gap-prewarm-cuda:0 import_s=9.952 ready_wait_s=5.781
TRUST4 finishes."""


def _stats(fills, kernel_ms, dedup=0.01, emit=0.02, device=0.05, left=0.0):
    return {"gap_fills": fills, "tier_kernel_ms": kernel_ms,
            "dedup_s": dedup, "emit_s": emit, "device_s": device,
            "cpu_left_s": left, "complete_wait_s": 0.04}


def _record(trace=True):
    lines = [(float(i), x) for i, x in enumerate(STDERR.split("\n"))]
    samples = [
        {"stderr": lines if trace else [], "n_reads": 100000,
         "stats": _stats(300000, [0.1, 0.2, 0.7])},
        {"stderr": [(t, x.replace("0.462", "0.538")) for t, x in lines]
         if trace else [], "n_reads": 100000,
         "stats": _stats(200000, [0.1, 0.1, 0.8], left=0.02)},
    ]
    return {"cold_s": 12.5, "setup_s": 16.9, "window_s": 4.0,
            "samples": samples, "boot_line": STDERR.split("\n")[-2],
            "trace": {"busy_s": 0.01, "window_s": 4.0} if trace else None}


WANT = {
    "reads_per_s": 50000.0,
    "cold_sample_s": 12.5,
    "setup_s": 16.9,
    "extract.s_per_sample": 0.5,
    "assemble.s_per_sample": 0.983,
    "annotate.s_per_sample": 0.872,
    "gap_oracle.s_per_sample": 0.09,
    "gap_oracle.fills_per_sample": 250000,
    "boot.import_s": 9.952,
    "boot.ready_wait_s": 5.781,
    "dp_counts.kernel_ms_per_sample": 1.0,
    "device.idle_share": 99.75,
}


# What each metric's reader reads on the run recorded here.  The metrics
# whose lines this record lacks are recorded by the test modules of their
# readers, each in its own METRICS (t4bench_common.metric_expectations).
METRICS = {name: (_record, want) for name, want in WANT.items()}


@pytest.fixture(scope="module")
def expected():
    return metric_expectations(ROOT)


@pytest.mark.parametrize("name", metric_names())
def test_reader(name, expected):
    assert name in expected, f"no test module records {name}"
    cell = Cell("bulk-se.receptor-rich")
    record, want = expected[name]
    assert cell.reader(name)(record()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["extract.s_per_sample",
                                  "assemble.s_per_sample",
                                  "annotate.s_per_sample",
                                  "device.idle_share"])
def test_reader_finds_nothing_without_tracing(name):
    cell = Cell("bulk-se.receptor-rich")
    assert cell.reader(name)(_record(trace=False)) is None


def test_every_metric_has_a_reader():
    check_metrics(ROOT)
