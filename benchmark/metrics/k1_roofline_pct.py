"""The LDPC decode's share of its roofline: the least time the card could
take for the code blocks' work (the iterations each needed, found by the
benchmark's plain decoder) over the device time of the operations
launched inside the decode (K1)."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("coding/decode")
    if not dev:
        return None
    least, by = run.path.work_of(run, "decode")
    run.notes["k1_roofline_pct"] = f"bounded by {by}, least {least * 1e3:.6f} ms"
    return 100.0 * least / dev
