"""The share of extraction's candidate tests decided on the card: the
program's counts (gap_oracle.STATS ``extract_reads``, the bulk stream's
tests decided on the card and on the host, counted while the program
records spans), the card's over both, the mean over the window's
samples.  None where a sample counted no test: tracing off, or a program
without the counts."""

from statistics import mean


def read(record):
    per = [s["stats"].get("extract_reads") for s in record["samples"]]
    if not per or not all(p and sum(p) for p in per):
        return None
    return mean(p[0] / sum(p) for p in per)
