"""Reference values of the distributed driver runs, from the JAX package on
the CPU with 8 virtual devices.

    JAX_PLATFORMS=cpu python refcheck/dist_smoke_pins.py [name ...]

Runs the JAX driver with `[parallelism] n_devices = 8` (its shard_map
halo program over 8 virtual CPU devices) on the configurations of
`tests/test_driver_distributed.py:58-173` and prints, per run, the norm
lines and the L2 error of every level as the Python literal that
`tests/test_torch_dist_driver.py` and `chip_smoke.py` phase 15 pin:

- sinx_hp: sinx on the brick, level 1, deg 2, max_degree 4, two
  smooth_pred steps, f64 CG (`test_distributed_sinx_matches_single_device`);
- sinx_mixed: uniform_h, one step, deg 2, mixed precision on
  (`test_distributed_sinx_mixed_precision`);
- cds: ConstantDensityStar, level 1, deg 2, no AMR step, CG, snes_atol
  1e-12 (`test_distributed_cds_matches_single_device`), with ψ_analytic as
  its Dirichlet data: the JAX driver's `CDSProblem.boundary` returns 1
  (ROADMAP C11), so this script replaces that method before it runs, as
  `refcheck/nonlinear_smoke_pins.py` does, and touches nothing else;
- mg: uniform_h, one step, FCG with pc_type = multigrid
  (`test_distributed_mg_pc_matches_single_device`).

The options text of each run is `options(name)`; the port's runs put
their own rank count in `n_devices`.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

COMMON = """
[initial_mesh]
min_level = 1
region0_deg = 2

[mesh_parameters]
max_degree = {maxdeg}

[flux]
sipg_penalty_prefactor = 2.0

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}
percentile = 25.0

[geometry]
name = brick

[d4est_solver_krylov_petsc]
ksp_type = {ksp}
use_mixed_precision = {mixed}
{pc}
[parallelism]
enable = auto
n_devices = {n}
"""

CDS = """
[initial_mesh]
min_level = 1
region0_deg = 2

[mesh_parameters]
max_degree = 2

[flux]
sipg_penalty_prefactor = 2.0

[problem]
R = 0.0625
cx = 0.5
cy = 0.5
cz = 0.5
rho0_div_rhoc = 0.001

[amr]
scheme = uniform_h
num_of_amr_steps = 0

[geometry]
name = brick

[d4est_solver_newton]
snes_atol = 1e-12
snes_max_it = 20

[d4est_solver_krylov_petsc]
ksp_type = cg

[parallelism]
enable = auto
n_devices = {n}
"""

RUNS = {
    "sinx_hp": dict(maxdeg=4, scheme="smooth_pred", steps=2, ksp="cg",
                    mixed=0, pc=""),
    "sinx_mixed": dict(maxdeg=2, scheme="uniform_h", steps=1, ksp="cg",
                       mixed=1, pc=""),
    "mg": dict(maxdeg=2, scheme="uniform_h", steps=1, ksp="fcg", mixed=0,
               pc="pc_type = multigrid\n"),
    "cds": None,
}


def options(name, n=8):
    """The options text of run `name` with `n_devices = n`."""
    if name == "cds":
        return CDS.format(n=n)
    return COMMON.format(n=n, **RUNS[name])


def run(name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from disco4est_tpu import driver
    from disco4est_tpu.problems.poisson import SinxProblem
    from disco4est_tpu.util.config import Options

    opts = Options.load(options(name))
    if name != "cds":
        res = driver.run_poisson(opts, SinxProblem)
        return res.norms.lines("L_2"), [r["L_2"] for r in res.norms.rows]
    boundary = driver.CDSProblem.boundary
    driver.CDSProblem.boundary = lambda self, *c: self.params.psi(*c)
    try:
        res = driver.run_nonlinear(opts, driver.CDSProblem(opts))
    finally:
        driver.CDSProblem.boundary = boundary
    return res.norms.lines("L_2"), [r["L_2"] for r in res.norms.rows]


def main(argv):
    for name in argv or list(RUNS):
        lines, l2 = run(name)
        print(f"{name}:")
        for line in lines:
            print(f"    {line!r}")
        print(f"    L2 {[float(v) for v in l2]!r}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
