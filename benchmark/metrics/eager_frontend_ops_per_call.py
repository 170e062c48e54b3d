"""Device operations (kernels, copies, sets) launched inside the eager
frontend's three spans (phy/channel_estimation.py, phy/equalization.py,
phy/llr.py) a call, over the traced stretch."""

SPANS = ("phy/channel_estimation.py", "phy/equalization.py", "phy/llr.py")


def read(run):
    ops = (run.trace or {}).get("layer_ops", {})
    n = sum(ops.get(k, 0) for k in SPANS)
    calls = len(run.traced_calls)
    return n / calls if n and calls else None
