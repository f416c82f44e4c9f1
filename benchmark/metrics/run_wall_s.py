"""`run_s` where it is not held end to end (the host-paced cell, whose
runs spread wider than any bound the contract allows): the wall seconds
of one driver run, the trace mode's plain runs' walls over their count."""


def read(rec):
    if "span_runs" not in rec or not rec.get("runs"):
        return None
    return sum(r["wall_s"] for r in rec["runs"]) / len(rec["runs"])
