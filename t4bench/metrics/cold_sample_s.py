"""The cold sample's wall: from before the port's import to the return of
run_trust4 on the pool's first sample."""


def read(record):
    return record["cold_s"]
