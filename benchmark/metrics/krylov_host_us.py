"""Host microseconds to enqueue one Krylov iteration (median over the
plain runs): the program's counter `krylov.host_ns` over
`krylov.iterations`, the host's time inside the outermost CG/FCG calls
outside their stopping-test reads.  With `krylov_wait_us` it sums to one
iteration's host wall.  Extra: B1 and B2 launches per iteration (the
run's deltas of the kernel modules' launch counters)."""

from benchmark import program_runs as P


def read(rec):
    return P.per_run(rec, lambda r: P.per_iteration(r, "krylov.host_ns",
                                                    1e-3))


def extra(rec):
    return dict(
        b1_launches_per_iter=P.per_run(
            rec, lambda r: P.per_iteration(r, "launches.b1")),
        b2_launches_per_iter=P.per_run(
            rec, lambda r: P.per_iteration(r, "launches.b2")))
