"""Device time per slot of the operations launched inside the LDPC
encoder (ldpc.encode, span coding/encode), over the traced stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("coding/encode")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
