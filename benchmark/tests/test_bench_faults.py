"""The check fails a run whose timed path is broken underneath.

Each test drives a whole run of a cell at a toy size on the CPU (the
harness's look for a card skipped) with one fault planted in the
program, and sees `correct` come out false.  The faults a cell of one
card can have: a solve that returns its state unchanged, half of the
elements left out of the problem, an answer altered where it is
produced, and a solve stopped one step short of the f64 floor (the
mixed solve's last outer refinement step cut, a plain solve stopped at
1000 times its tolerance, the Newton solve's last step cut).  No cell
exchanges data between cards.
"""

import time

import pytest
import torch

from benchmark import control, harness
from disco4est_tpu_torch import driver
from disco4est_tpu_torch.problems import constant_density_star as cds
from disco4est_tpu_torch.solvers.newton import NewtonResult

LINEAR = ["sinx_brick_l5_deg3", "sinx_brick_l5_deg3_f64",
          "sinx_brick_l4_deg7", "sinx_brick_l6_deg3"]


def _run(name, toy):
    code, line = harness.run_cell(name, 2**31 + 5, 0.1, False,
                                  t_start=time.perf_counter(), device="cpu",
                                  cell=toy(name))
    assert code == 0
    return line


def _half(x):
    x = x.clone()
    x[x.shape[0] // 2:] = 0.0
    return x


def _altered(u):
    u = u.clone()
    u[0] += 1e-6
    return u


# At deg 7 the mixed solve's last outer steps stall at the f64 floor: cut,
# the last one leaves the same residual on every problem (PERF.md), so a
# solve stopped one step early there is no weaker result
CASES = [(name, fault) for name in LINEAR
         for fault in ("unchanged", "half", "altered", "early")
         if (name, fault) != ("sinx_brick_l4_deg7", "early")]


@pytest.mark.parametrize("name,fault", CASES)
def test_linear_fault_fails(name, fault, toy, monkeypatch):
    solve, rhs = driver._solve, driver.build_rhs_with_strong_bc
    if fault == "early":
        with control.stopped_early():
            assert _run(name, toy)["correct"] is False
        return
    if fault == "unchanged":
        monkeypatch.setattr(driver, "_solve", lambda mesh, b, x0, **kw: (
            solve(mesh, b, x0, **kw)[0], x0))
    elif fault == "half":
        monkeypatch.setattr(driver, "build_rhs_with_strong_bc",
                            lambda *a: _half(rhs(*a)))
    else:
        def altered(*a, **kw):
            info, u = solve(*a, **kw)
            return info, _altered(u)
        monkeypatch.setattr(driver, "_solve", altered)
    assert _run(name, toy)["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "early"])
def test_nonlinear_fault_fails(fault, toy, monkeypatch):
    newton, mass = driver.newton_solve, cds.apply_mass_fof
    if fault == "early":
        with control.stopped_early():
            assert _run("cds_brick_l5_deg2", toy)["correct"] is False
        return
    if fault == "unchanged":
        def unchanged(residual, jac, u0, params, callback=None):
            f = float(torch.linalg.vector_norm(residual(u0)))
            return NewtonResult(u=u0, iterations=0, residual_norm=f,
                                history=[f])
        monkeypatch.setattr(driver, "newton_solve", unchanged)
    elif fault == "half":
        monkeypatch.setattr(cds, "apply_mass_fof",
                            lambda mesh, u, fof: _half(mass(mesh, u, fof)))
    else:
        def altered(*a, **kw):
            res = newton(*a, **kw)
            return res._replace(u=_altered(res.u))
        monkeypatch.setattr(driver, "newton_solve", altered)
    assert _run("cds_brick_l5_deg2", toy)["correct"] is False


@pytest.mark.parametrize("name", LINEAR + ["cds_brick_l5_deg2"])
def test_sound_run_passes(name, toy):
    assert _run(name, toy)["correct"] is True
