"""Mean over the calls handed in during the traced stretch of the earlier
calls still running on the card at the hand-in (the program's counter
runtime/executor.py:inflight, 0 to the executor's depth)."""
from benchmark.spans import mean


def read(run):
    return mean("runtime/executor.py:inflight")
