"""Seconds of the preconditioner's set-up per run (median over the plain
runs): the program's spans `d4est.pc` around `driver._build_pc`'s steps,
summed over a run's epochs.  The span and its steps synchronize the card
at both ends, so it holds their own work.  Nothing where the runs build
no preconditioner.  Extras: the same of the steps' spans
`d4est.pc.hierarchy` (the coarse forests, meshes and transfer tables of
`build_hierarchy`) and `d4est.pc.mg_setup` (`eigs_s`: the levels'
CG-Lanczos bounds and the dense bottom matrix of `mg_setup`)."""

from benchmark import program_runs as P


def _seconds(name):
    def value(record):
        spans = P.span_seconds(record, name)
        return sum(spans) if spans else None
    return value


def read(rec):
    return P.per_run(rec, _seconds("d4est.pc"))


def extra(rec):
    return dict(hierarchy_s=P.per_run(rec, _seconds("d4est.pc.hierarchy")),
                eigs_s=P.per_run(rec, _seconds("d4est.pc.mg_setup")))
