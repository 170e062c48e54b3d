"""Device operations (kernels, copies, sets) launched inside the LDPC
encoder (span coding/encode) a call, over the traced stretch."""


def read(run):
    ops = (run.trace or {}).get("layer_ops", {}).get("coding/encode")
    calls = len(run.traced_calls)
    return ops / calls if ops and calls else None
