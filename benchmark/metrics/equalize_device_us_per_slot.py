"""Device time per slot of the eager frontend's detector (span
phy/equalization.py: pusch_equalize, the MMSE per data RE), over the traced
stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("phy/equalization.py")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
