"""Device time per slot of the slot executor's retire (``to_host``): the
copies of each call's tb_bits, tb_ok and cb_ok to the host, over the
traced stretch."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("runtime/executor.py")
    slots = len(run.traced_calls) * run.slots_per_call
    return dev / slots * 1e6 if dev and slots else None
