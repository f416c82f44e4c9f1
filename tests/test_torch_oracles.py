"""The reference oracles through the port, on the CPU, at the JAX digit
tests' tolerances (`refcheck/oracle_smoke_pins.py`; the constructions are
`disco4est_tpu_torch/tools/oracles.py`, which mirror the JAX tests):

- the sinx regression's grep digit, the L2 of the interpolated nodal |e|
  (`tests/test_laplacian.py:133-154`);
- the CDS + 1 AMR step L2 and energy estimator (`tests/test_cds.py:
  64-126`);
- the 13-tree TwoPunctures digit u(100, 0, 0)
  (`tests/test_regression_digits.py:131-190`);
- the 4-level TwoPunctures smooth_pred trajectory
  (`tests/test_tp_trajectory.py:64`), one case a level;
- rows 0-5 of the Stamm hp-AMR trajectory
  (`tests/test_regression_digits.py:268-420`), one case a row; rows 6-7
  run on the card (`chip_smoke.py` phase 17).

No JAX runs here: the values are the compiled reference's.
"""

import pathlib
import sys

import pytest

from disco4est_tpu_torch.tools import oracles

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "refcheck"))
import oracle_smoke_pins as P  # noqa: E402
from torch_threads import torch_worker_threads  # noqa: E402, F401

STAMM_CPU_ROWS = 6


def test_sinx_interp_abs_digit():
    r = oracles.sinx_regression("cpu")
    pin = P.SINX
    assert (r["n_elements"], r["local_nodes"]) == (pin["n_elements"],
                                                   pin["local_nodes"])
    assert abs(r["l2_interp_abs"] - pin["l2_interp_abs"]) < pin["abs_tol"], r
    assert abs(r["l2"] - pin["l2"]) < pin["abs_tol"], r


def test_cds_amr_estimator():
    r = oracles.cds_amr("cpu")
    pin = P.CDS
    assert r["n_elements"] == pin["n_elements"]
    assert r["local_nodes"] == pin["local_nodes"]
    assert r["marked"] == pin["marked"]
    assert max(r["residual_norm"]) < pin["residual_norm"], r
    lo, hi = pin["l2_0_range"]
    assert lo <= r["l2"][0] < hi, r
    assert abs(r["l2"][1] - pin["l2_1"]) < pin["l2_1_abs"], r
    assert abs(r["estimator"] - pin["estimator"]) < pin["estimator_abs"], r


def test_two_punctures_13tree_digit():
    r = oracles.two_punctures_13tree("cpu")
    pin = P.TP13
    assert (r["n_elements"], r["local_nodes"]) == (pin["n_elements"],
                                                   pin["local_nodes"])
    assert r["residual_norm"] < pin["residual_norm"], r
    assert abs(r["u_100"] - pin["u_100"]) < pin["abs_tol"], r


@pytest.fixture(scope="module")
def tp_rows():
    return oracles.two_punctures_trajectory("cpu",
                                            levels=len(P.TP_TRAJECTORY))


@pytest.mark.parametrize("level", range(len(P.TP_TRAJECTORY)))
def test_two_punctures_trajectory(tp_rows, level):
    E, nodes, eta2_sum, tol = P.TP_TRAJECTORY[level]
    row = tp_rows[level]
    assert row["residual_norm"] < P.TP_TRAJECTORY_RESIDUAL, row
    assert (row["n_elements"], row["nodes"]) == (E, nodes)
    assert abs(row["eta2_sum"] - eta2_sum) <= tol * eta2_sum, row


@pytest.fixture(scope="module")
def stamm_rows():
    return oracles.stamm_trajectory("cpu", rows=STAMM_CPU_ROWS)


@pytest.mark.parametrize("row", range(STAMM_CPU_ROWS))
def test_stamm_trajectory(stamm_rows, row):
    """Row `row` of the Stamm oracle: the element and node counts exact
    (456 after the first smooth_pred step, the marking), the L2 and the
    estimate to 1e-10 (5e-10 at row 5).  Rows 0-3 were
    `test_torch_nonlinear_driver.py::test_stamm_trajectory_rows_0_to_3`."""
    *_, l2_tol, est_tol = P.STAMM[row]
    l2_rel, est_rel, counts = P.stamm_row_errors(stamm_rows[row],
                                                 P.STAMM[row])
    assert counts, stamm_rows[row]
    assert l2_rel < l2_tol, (row, stamm_rows[row])
    assert est_rel < est_tol, (row, stamm_rows[row])
