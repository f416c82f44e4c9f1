"""CLI: `python -m disco4est_tpu_torch options.input [--problem=sinx]
[--device=cuda|cpu]`.

Port of `disco4est_tpu/__main__.py`.  The problem comes from `--problem=`
or `[problem] name`; the device from `--device=` (default `cuda`; a
missing card raises).  Linear problems (sinx, lorentzian, stamm) run the
AMR-Krylov loop and print the reference-format norm line of each level,
one line per solve (path, iteration counts, whether the f64 fallback ran,
wall time) and the convergence fit when there are two or more levels.
Nonlinear problems (constant_density_star / cds, okendon, two_punctures)
run the Newton–Krylov loop and print the norm lines (L2 error, or ‖F‖
where the problem has no analytic solution), one Newton line per level
(iterations, ‖F‖, Krylov iterations, wall time, ‖F‖ history) and the fit.
"""

import sys

from disco4est_tpu_torch.driver import (
    CDSProblem,
    OkendonProblem,
    TwoPuncturesProblem,
    run_nonlinear,
    run_poisson,
)
from disco4est_tpu_torch.problems.poisson import (
    LorentzianProblem,
    SinxProblem,
)
from disco4est_tpu_torch.problems.stamm import StammProblem
from disco4est_tpu_torch.util.config import Options


def _stamm(opts):
    return StammProblem(
        c=(
            opts.get_float("problem", "c2x", 0.5),
            opts.get_float("problem", "c2y", 0.5),
            opts.get_float("problem", "c2z", 0.5),
        ),
        dim=3,
    )


LINEAR_PROBLEMS = {
    "sinx": lambda opts: SinxProblem,
    "lorentzian": lambda opts: LorentzianProblem,
    "stamm": _stamm,
}
NONLINEAR_PROBLEMS = {
    "constant_density_star": CDSProblem,
    "cds": CDSProblem,
    "okendon": OkendonProblem,
    "two_punctures": TwoPuncturesProblem,
}

USAGE = (
    "usage: python -m disco4est_tpu_torch options.input [--problem=sinx] "
    "[--device=cuda|cpu]"
)


def main(argv):
    if not argv:
        print(USAGE)
        return 1
    opts = Options.load(argv[0])
    if opts.get("logging", "log_dir", None):
        raise NotImplementedError(
            "[logging] log_dir is not ported yet (ROADMAP A14)"
        )
    name = opts.get("problem", "name", "sinx")
    device = "cuda"
    for a in argv[1:]:
        if a.startswith("--problem="):
            name = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith(("--plot-checkpoint=", "--output=")):
            raise NotImplementedError(
                "the checkpoint plotter is not ported yet (ROADMAP A14)"
            )
        else:
            print(f"unknown argument {a!r}\n{USAGE}")
            return 1
    if name in NONLINEAR_PROBLEMS:
        result = run_nonlinear(opts, NONLINEAR_PROBLEMS[name](opts),
                               device=device)
        key = "L_2" if "L_2" in result.norms.rows[-1] else "F_norm"
    elif name in LINEAR_PROBLEMS:
        result = run_poisson(opts, LINEAR_PROBLEMS[name](opts),
                             device=device)
        key = "L_2"
    else:
        known = sorted(set(LINEAR_PROBLEMS) | set(NONLINEAR_PROBLEMS))
        print(f"unknown problem {name!r}; known: {known}")
        return 1

    for line in result.norms.lines(key):
        print(line)
    for level, info in enumerate(result.solves):
        print(info.line(level))
    fit = result.norms.convergence_fit(key)
    if fit:
        print(f"C1 = {fit['intercept']:.6f}, C2 = {fit['slope']:.15f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
