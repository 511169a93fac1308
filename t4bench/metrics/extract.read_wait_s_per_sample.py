"""Extraction's wait for the read per sample: the program's
``extract/read_wait`` counter, the seconds the native stream's calling
thread stood waiting for its reader thread's next batch (the opening
included).  Beside ``extract.read_s_per_sample``, the reader thread's
busy time, 1 - read_wait / read is the share of the read hidden behind
the filter."""

from t4bench.span_lines import mean_span


def read(record):
    return mean_span(record, "extract/read_wait")
