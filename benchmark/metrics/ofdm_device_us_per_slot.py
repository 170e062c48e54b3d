"""Device time per slot of the OFDM layer (span phy/ofdm.py): the
demodulation in an RX cell (cuFFT and the grid's extraction), the
modulation in a TX cell (the mapping to the FFT grid and the inverse
cuFFT with the cyclic prefixes), over the traced stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("phy/ofdm.py")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
