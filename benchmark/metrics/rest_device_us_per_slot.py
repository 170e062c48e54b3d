"""Device time per slot of the coding layer's steps other than the decode:
rate recovery, desegmentation and the transport block's CRC, over the
traced stretch."""

OWN = ("coding/rate_recovery", "coding/desegment", "coding/crc")


def read(run):
    layers = (run.trace or {}).get("layer_s")
    slots = len(run.traced_calls) * run.slots_per_call
    if not layers or not slots:
        return None
    dev = sum(layers.get(k, 0.0) for k in OWN)
    return dev / slots * 1e6 if dev else None
