"""Gap fills per sample: gap_oracle.STATS ``gap_fills``."""

from t4bench.readers import mean_stat


def read(record):
    return mean_stat(record, lambda st: st["gap_fills"])
