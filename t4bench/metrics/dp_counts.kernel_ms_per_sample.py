"""The counts kernel's device milliseconds per sample: gap_oracle.STATS
``tier_kernel_ms`` (CUDA events around each launch), summed over tiers."""

from t4bench.readers import mean_stat


def read(record):
    return mean_stat(record, lambda st: sum(st["tier_kernel_ms"]))
