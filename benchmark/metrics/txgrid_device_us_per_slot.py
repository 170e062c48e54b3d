"""Device time per slot of pusch_tx's own operations (span models/pusch.py
less the encoder and the OFDM inside it: the CRCs, segmentation, rate
matching, scrambling, QAM, layer and RE mapping, the DMRS), over the
traced stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("models/pusch.py")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
