"""Host time a call in the slot executor's copy of the results to the host
(the program's span runtime/executor.py around to_host), over the traced
stretch."""
from benchmark.spans import span_ms


def read(run):
    return span_ms("runtime/executor.py")
