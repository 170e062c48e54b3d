"""95th percentile over the calls of the traced stretch of the time from
the end of a call's dispatch to the start of its retire (the program's
counter runtime/executor.py:held, in seconds)."""
from benchmark.harness import percentile
from benchmark.spans import readings


def read(run):
    got = readings("runtime/executor.py:held")
    return percentile([r.total * 1e3 for r in got], 95) if got else None
