"""95th percentile of how late the load generator handed a call in: the
executor takes the next call only once it has retired the one `depth`
calls back (open loop)."""
from benchmark.harness import percentile


def read(run):
    return percentile([(h - d) * 1e3 for d, h in zip(run.due, run.handed)], 95)
