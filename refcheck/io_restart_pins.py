"""A level checkpoint and the final iterate of a JAX driver run, for the
port's restart-from-a-JAX-checkpoint test (`tests/test_torch_restart.py`).

    JAX_PLATFORMS=cpu python refcheck/io_restart_pins.py

Runs the JAX driver (`disco4est_tpu.driver.run_poisson`) on the linear
options of `tests/test_restart.py` (sinx on the brick from level 1, deg 2,
hp smooth_pred to `max_degree = 3`, two steps) with `[checkpoint] prefix`,
then writes into `tests/data/`:

- `jax_restart_level1.npz`: the JAX driver's own level-1 checkpoint (its
  forest, storage-degree u, AMR history, degrees and predictor);
- `jax_restart_final_u.npy`: the run's final u (padded own degrees);

and prints the final level's norm line and L2.  About 20 s on an 8-core
CPU, JAX's compiles included.
"""

import os
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from disco4est_tpu.driver import run_poisson  # noqa: E402
from disco4est_tpu.problems.poisson import SinxProblem  # noqa: E402
from disco4est_tpu.util.config import Options  # noqa: E402

OPTIONS = """
[initial_mesh]
min_level = 1
region0_deg = 2

[mesh_parameters]
max_degree = 3

[flux]
sipg_penalty_prefactor = 2.0

[amr]
scheme = smooth_pred
num_of_amr_steps = 2
percentile = 25.0

[geometry]
name = brick

[checkpoint]
prefix = {prefix}
"""


def main():
    data = ROOT / "tests" / "data"
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "ck")
        res = run_poisson(Options.load(OPTIONS.format(prefix=prefix)),
                          SinxProblem)
        shutil.copy(f"{prefix}_level1.npz", data / "jax_restart_level1.npz")
    np.save(data / "jax_restart_final_u.npy", np.asarray(res.u))
    print(res.norms.lines("L_2")[-1])
    print(f"final L2 {res.norms.rows[-1]['L_2']!r}")


if __name__ == "__main__":
    main()
