"""The gap oracle's wall per sample: gap_oracle.STATS dedup, emission,
device (launches, the completion wait and the copy back) and the CPU
leftover seconds, reset before each sample."""

from t4bench.readers import mean_stat


def read(record):
    return mean_stat(record, lambda st: st["dedup_s"] + st["emit_s"]
                     + st["device_s"] + st["cpu_left_s"])
