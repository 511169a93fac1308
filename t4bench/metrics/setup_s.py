"""The whole set-up: references, the pool, the builds, the cold and the
warm sample."""


def read(record):
    return record["setup_s"]
