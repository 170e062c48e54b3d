"""Host self time a call of the program's span phy/ofdm.py (the FFT and
the grid's extraction inside pusch_rx), over the traced stretch."""
from benchmark.spans import self_ms


def read(run):
    return self_ms(("phy/ofdm.py",))
