"""The LDPC encoder's share of its roofline: the least time the card could
take for the traced calls' code blocks (benchmark/workcount.py's
encoder_work: the information bits read and the transmitted mother-code
columns written, one bit each; a 32-bit XOR an edge and 32 lifted bits)
over the device time of the operations launched inside ldpc.encode."""


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("coding/encode")
    if not dev:
        return None
    least, by = run.path.work_of(run, "encode")
    run.notes["encode_roofline_pct"] = f"bounded by {by}, least {least * 1e3:.6f} ms"
    return 100.0 * least / dev
