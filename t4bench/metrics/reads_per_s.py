"""Input reads of every sample the window completed (cDNA reads for 10x)
over the time from the window's start to the end of its last sample."""


def read(record):
    if not record["samples"]:
        return None
    return sum(s["n_reads"] for s in record["samples"]) / record["window_s"]
