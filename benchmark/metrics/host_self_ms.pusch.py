"""Host self time a call of the program's span models/pusch.py: pusch_rx
less its stages (the bf16 staging of the planes, the graph and table
lookups, the output dict), over the traced stretch."""
from benchmark.spans import self_ms


def read(run):
    return self_ms(("models/pusch.py",))
