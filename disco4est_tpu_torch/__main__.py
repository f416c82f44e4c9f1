"""CLI: `python -m disco4est_tpu_torch options.input [--problem=sinx]
[--device=cuda|cpu]`.

Port of `disco4est_tpu/__main__.py` for the linear Poisson problems.
The problem comes from `--problem=` or `[problem] name`; the device from
`--device=` (default `cuda`; a missing card raises).  Prints the
reference-format norm line of each level, one line per solve
(path, iteration counts, whether the f64 fallback ran, wall time), and
the convergence fit when there are two or more levels.
"""

import sys

from disco4est_tpu_torch.driver import run_poisson
from disco4est_tpu_torch.problems.poisson import (
    LorentzianProblem,
    SinxProblem,
)
from disco4est_tpu_torch.util.config import Options

LINEAR_PROBLEMS = {
    "sinx": SinxProblem,
    "lorentzian": LorentzianProblem,
}
UNPORTED_PROBLEMS = {
    "stamm": "A12",
    "constant_density_star": "A12",
    "cds": "A12",
    "okendon": "A12",
    "two_punctures": "A12",
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
    if name in UNPORTED_PROBLEMS:
        raise NotImplementedError(
            f"problem {name!r} is not ported yet "
            f"(ROADMAP {UNPORTED_PROBLEMS[name]})"
        )
    if name not in LINEAR_PROBLEMS:
        known = sorted(set(LINEAR_PROBLEMS) | set(UNPORTED_PROBLEMS))
        print(f"unknown problem {name!r}; known: {known}")
        return 1

    result = run_poisson(opts, LINEAR_PROBLEMS[name], device=device)
    for line in result.norms.lines("L_2"):
        print(line)
    for level, info in enumerate(result.solves):
        print(info.line(level))
    fit = result.norms.convergence_fit("L_2")
    if fit:
        print(f"C1 = {fit['intercept']:.6f}, C2 = {fit['slope']:.15f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
