"""Host self time a call of the program's spans of the eager frontend
(phy/channel_estimation.py, phy/equalization.py, phy/llr.py inside
pusch_frontend, where K3 does not run), summed, over the traced
stretch."""
from benchmark.spans import self_ms

EAGER = ("phy/channel_estimation.py", "phy/equalization.py", "phy/llr.py")


def read(run):
    return self_ms(EAGER)
