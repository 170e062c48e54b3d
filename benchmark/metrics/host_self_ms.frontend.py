"""Host self time a call of the program's span ops/pusch_frontend.py
(frontend_planes: K3's plan, arguments and launch), over the traced
stretch."""
from benchmark.spans import self_ms


def read(run):
    return self_ms(("ops/pusch_frontend.py",))
