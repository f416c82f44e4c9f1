"""Share of its roofline that the f32 inner apply reaches: the least time
of one apply at the cell's shapes (`counts.least_seconds`) times the
applies, over the device time of all kernels inside the
`structured.apply_structured` spans of the profiled runs, in percent.
Nothing where the runs make no such call."""

from benchmark import counts


def _parts(rec):
    prof = rec.get("profile") or {}
    shape = (rec.get("shapes") or {}).get("apply_structured")
    calls = (prof.get("calls") or {}).get("apply_structured", 0)
    dev = (prof.get("span_device_s") or {}).get("apply_structured", 0.0)
    if not shape or not calls or dev <= 0:
        return None
    inc = int(rec["options"].get("initial_mesh", {}).get(
        "region0_deg_quad_inc", 0))
    nl = shape["deg"] + 1
    least, bound = counts.least_seconds(shape["E"], shape["dim"], nl,
                                        nl + inc)
    return least, bound, calls, dev


def read(rec):
    parts = _parts(rec)
    if parts is None:
        return None
    least, _, calls, dev = parts
    return 100.0 * least * calls / dev


def extra(rec):
    least, bound, calls, dev = _parts(rec)
    return dict(bound=bound, least_us=least * 1e6, applies=calls,
                device_us_per_apply=dev / calls * 1e6,
                launches_matched=rec["profile"].get("launches_matched"),
                power_limit_w=rec.get("power_limit_w"))
