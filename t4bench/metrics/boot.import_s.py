"""torch's import on the boot thread in the cold sample (its ``[boot]``
line's ``import_s``)."""

from t4bench.readers import boot


def read(record):
    b = boot(record)
    return None if b is None else b[0]
