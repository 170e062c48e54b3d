"""Device time of the OFDM demodulation (cuFFT and the grid's extraction)
per slot over the traced stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("phy/ofdm.py")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
