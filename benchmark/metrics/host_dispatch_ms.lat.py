"""Mean host time to enqueue one call's work, from the slot executor's own
SlotStats.dispatch_us over the untraced stretch of the window."""


def read(run):
    return sum(run.dispatch_us) / len(run.dispatch_us) / 1e3 if run.dispatch_us else None
