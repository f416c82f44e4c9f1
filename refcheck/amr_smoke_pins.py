"""Reference values of the AMR runs of `chip_smoke.py` phase 9, from the
JAX package on the CPU.

    JAX_PLATFORMS=cpu python refcheck/amr_smoke_pins.py [a|b|c ...]

Runs the JAX driver (`disco4est_tpu.driver.run_poisson`) on the sinx
options of each pinned run and prints, per AMR level, the element count,
the DOF, the histogram of the per-element degrees and the L2 error, as the
Python literal that `chip_smoke.py` pins:

- a: uniform_h at deg 3 from level 4, no step (the level-4 epoch of run
  (a); its level 5 is `LEVEL5_L2`);
- b: uniform_p from level 4, deg 3, max_degree 5, two steps;
- c: hp smooth_pred from level 3, deg 2, max_degree 4, percentile 25,
  three steps.

The per-level degrees are read by wrapping the driver's `build_mesh`,
which it calls once per epoch with that epoch's `deg_e`.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from disco4est_tpu import driver  # noqa: E402
from disco4est_tpu.problems.poisson import SinxProblem  # noqa: E402
from disco4est_tpu.util.config import Options  # noqa: E402

OPTIONS = """
[initial_mesh]
min_level = {level}
region0_deg = {deg}
region0_deg_quad_inc = 0

[mesh_parameters]
face_h_type = FACE_H_EQ_VOLUME_DIV_AREA
volume_h_type = VOL_H_EQ_CUBE_APPROX
max_degree = {max_degree}

[flux]
name = sipg
sipg_penalty_prefactor = 2.0
sipg_flux_h = H_EQ_VOLUME_DIV_AREA
sipg_penalty_fcn = maxp_sqr_over_minh

[amr]
scheme = {scheme}
num_of_amr_steps = {steps}
percentile = 25
gamma_h = 10.0
gamma_p = 0.1
gamma_n = 1.0

[geometry]
name = brick

[d4est_solver_krylov_petsc]
ksp_type = fcg
ksp_atol = 5e-15
use_structured = 0

[quadrature]
name = legendre
"""

RUNS = {
    "a": dict(level=4, deg=3, max_degree=3, scheme="uniform_h", steps=0),
    "b": dict(level=4, deg=3, max_degree=5, scheme="uniform_p", steps=2),
    "c": dict(level=3, deg=2, max_degree=4, scheme="smooth_pred", steps=3),
}


def run(key):
    epochs = []
    build = driver.build_mesh

    def recording_build(geom, forest, **kw):
        deg_e = np.asarray(kw["deg_e"])
        values, counts = np.unique(deg_e, return_counts=True)
        epochs.append((forest.n_elements,
                       {int(v): int(c) for v, c in zip(values, counts)}))
        return build(geom, forest, **kw)

    driver.build_mesh = recording_build
    try:
        res = driver.run_poisson(Options.load(OPTIONS.format(**RUNS[key])),
                                 SinxProblem)
    finally:
        driver.build_mesh = build
    rows = res.norms.rows
    assert len(rows) == len(epochs)
    return [
        (E, r["num_nodes"], hist, float(r["L_2"]))
        for (E, hist), r in zip(epochs, rows)
    ]


def main(argv):
    for key in argv or sorted(RUNS):
        print(f"{key}: {RUNS[key]}")
        for row in run(key):
            print(f"    ({row[0]}, {row[1]}, {row[2]}, {row[3]!r}),")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
