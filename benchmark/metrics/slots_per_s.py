"""Slots whose results came back on the host in the window, over the
window's whole time (closed loop)."""


def read(run):
    return run.calls * run.slots_per_call / run.window_s if run.calls else None
