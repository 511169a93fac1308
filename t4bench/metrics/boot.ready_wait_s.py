"""The main thread's wait at the joins in the cold sample (its ``[boot]``
line's ``ready_wait_s``)."""

from t4bench.readers import boot


def read(record):
    b = boot(record)
    return None if b is None else b[1]
