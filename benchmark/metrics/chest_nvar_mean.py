"""Mean over the traced calls' slots of the eager frontend's noise
variance estimate, the MMSE's regulariser (the program's counter
phy/channel_estimation:nvar, each call's (B,) estimates summed)."""
from benchmark.spans import mean


def read(run):
    return mean("phy/channel_estimation:nvar")
