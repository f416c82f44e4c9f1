"""The card's peak allocated memory over the window, in GiB
(`torch.cuda.max_memory_allocated`, reset after set-up)."""


def read(rec):
    peak = rec.get("window_peak_bytes") or 0
    return peak / 2**30 if peak > 0 else None
