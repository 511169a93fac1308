"""Annotation's and the reports' wall per sample: ``[stage-time]
annotate`` plus ``report``."""

from t4bench.readers import mean_stage


def read(record):
    return mean_stage(record, ["annotate", "report"])
