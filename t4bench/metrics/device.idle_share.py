"""The device's idle share of the window, percent: 100 x (1 - busy /
window), busy the union of every device operation's interval in the
profiler's trace."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
