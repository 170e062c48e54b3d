"""The frontend's share of its roofline: the least time the card could
take for the estimate, detector and LLRs of the traced slots over the
device time of the operations launched inside frontend_planes (K3)."""
from benchmark.harness import work_of


def read(run):
    dev = (run.trace or {}).get("layer_s", {}).get("ops/pusch_frontend.py")
    if not dev:
        return None
    least, by = work_of(run, "frontend")
    run.notes["k3_roofline_pct"] = f"bounded by {by}, least {least * 1e3:.6f} ms"
    return 100.0 * least / dev
