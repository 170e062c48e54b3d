"""The eager detector's share of its roofline: the least time the card
could take for the traced slots' MMSE (the path's work_of(run,
"equalize"): the data REs and the estimate read once, the symbols and
their gains written once; one factorisation a subcarrier) over the device
time of the operations launched inside pusch_equalize."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("phy/equalization.py")
    if not dev:
        return None
    least, by = run.path.work_of(run, "equalize")
    run.notes["equalize_roofline_pct"] = f"bounded by {by}, least {least * 1e3:.6f} ms"
    return 100.0 * least / dev
