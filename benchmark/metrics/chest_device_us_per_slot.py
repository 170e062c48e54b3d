"""Device time per slot of the eager frontend's channel estimate (span
phy/channel_estimation.py: pusch_channel_estimate, both CDM groups' LS,
OCC split, window and comb-2 interpolation), over the traced stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("phy/channel_estimation.py")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
