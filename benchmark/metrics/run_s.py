"""Wall seconds of one driver run to its stopping test: the window's
wall time, up to the end of its last finished run, over the runs."""


def read(rec):
    if not rec.get("runs_done"):
        return None
    return rec["window_s"] / rec["runs_done"]
