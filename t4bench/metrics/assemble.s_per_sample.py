"""Assembly's wall per sample: the program's ``[stage-time] assemble``."""

from t4bench.readers import mean_stage


def read(record):
    return mean_stage(record, ["assemble"])
