"""95th percentile over every call of the window of the time from when the
call's slots were due to when their results were on the host (open loop)."""
from benchmark.harness import percentile


def read(run):
    return percentile(run.latency_ms, 95)
