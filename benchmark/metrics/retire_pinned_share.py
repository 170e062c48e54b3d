"""Share of the result bytes of the traced stretch's calls that the slot
executor handed back in pinned host memory (the program's counter
runtime/executor.py:pinned, one reading a call, 0 to 1)."""
from benchmark.spans import mean


def read(run):
    return mean("runtime/executor.py:pinned")
