"""Launches of the Jacobian's mass kernel per Krylov iteration (median
over the plain runs): the program's counter `launches.mass` (the run's
delta of `laplacian/nonlinear.py`'s `KERNEL_LAUNCHES`) over
`krylov.iterations`.  One launch per Jacobian apply, so a little over 1
where every apply of a Newton solve goes through the kernel (each CG or
FCG call adds the apply of its initial residual), 0 where none does.
Nothing where the program keeps no such counter."""

from benchmark import program_runs as P

COUNTER = "launches.mass"


def per_iteration(record):
    """The counter over the record's Krylov iterations; None where the
    record has no such counter or no iterations."""
    if COUNTER not in record["counters"]:
        return None
    return P.per_iteration(record, COUNTER)


def read(rec):
    return P.per_run(rec, per_iteration)
