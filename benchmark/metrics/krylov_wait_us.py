"""Host microseconds blocked in one Krylov iteration's stopping-test read
(median over the plain runs): the program's counter `krylov.wait_ns` over
`krylov.iterations`, the wait on the card inside the reads of the
outermost CG/FCG calls.  Extra: the reads per iteration (`krylov.reads`;
each call also reads ‖b‖ and its last, failing test)."""

from benchmark import program_runs as P


def read(rec):
    return P.per_run(rec, lambda r: P.per_iteration(r, "krylov.wait_ns",
                                                    1e-3))


def extra(rec):
    return dict(reads_per_iter=P.per_run(
        rec, lambda r: P.per_iteration(r, "krylov.reads")))
