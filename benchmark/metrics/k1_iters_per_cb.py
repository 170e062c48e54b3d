"""K1's own iterations a code block over the traced calls (the program's
counter coding/decode:iters, each call's (B*C,) counts summed); the plain
reference's mean over the same pool entries goes to the run's notes."""
from benchmark.spans import readings


def read(run):
    got = readings("coding/decode:iters")
    n = sum(r.n for r in got)
    if not n:
        return None
    ref = [i for j in getattr(run, "traced_calls", []) for i in run.iters.get(j, [])]
    if ref:
        run.notes["k1_iters_per_cb"] = (f"the plain reference's mean over the same calls "
                                        f"{sum(ref) / len(ref):.4f}")
    return sum(r.total for r in got) / n
