"""Seconds of the mesh build's host face tables per run (median over the
plain runs): the program's span `d4est.mesh.faces` around
`mesh.faces.build_face_tables` in `mesh.builder.build_mesh`, summed over
a run's builds.  Extra: the build's other parts, the same way (spans
`d4est.mesh.factors`, `.orient`, `.mortars`, `.h2d`: the geometry
factors and penalties, the orientation permutations, the hanging-face
mortar tables, the host-to-device copies), with no synchronize, so a
part holds its host work and its launches."""

from benchmark import program_runs as P

PARTS = ("factors", "orient", "mortars", "h2d")


def _seconds(name):
    def value(record):
        spans = P.span_seconds(record, f"d4est.mesh.{name}")
        return sum(spans) if spans else None
    return value


def read(rec):
    return P.per_run(rec, _seconds("faces"))


def extra(rec):
    return {f"{name}_s": P.per_run(rec, _seconds(name)) for name in PARTS}
