"""Host time a call the slot executor's retire blocked on the call's event
(the program's span runtime/executor.py:wait), over the traced stretch."""
from benchmark.spans import span_ms


def read(run):
    return span_ms("runtime/executor.py:wait")
