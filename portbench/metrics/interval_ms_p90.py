"""The 90th percentile over every output interval of the window of its wall
time, from the interval's start to its output on the host, in ms.  None
with fewer than ten intervals: no tail to read."""
import statistics


def read(rec):
    ms = rec["interval_ms"]
    return statistics.quantiles(ms, n=10)[-1] if len(ms) >= 10 else None
