"""The reference oracles that `tests/test_torch_oracles.py` and
`chip_smoke.py` phase 17 hold the port to, with their tolerances.

Every value is the compiled reference code's (`refcheck/GROUND_TRUTH.md`),
copied from the JAX package's digit tests, which hold the JAX package to
the same values at the same tolerances; nothing here is computed, and this
module imports nothing.  The port's constructions that produce them are in
`disco4est_tpu_torch/tools/oracles.py`.
"""

# `tests/test_laplacian.py:133-154`: brick level 2, deg 1, the reference's
# π; the L2 of the interpolated nodal |e| (the reference's grep digit
# `64 512 512 0.0426895934625`, refcheck/poisson_sinx_cg.c) and the true
# L2 error, each to 1e-12 absolute.
SINX = dict(n_elements=64, local_nodes=512,
            l2_interp_abs=0.0426895934625020, l2=0.024413557923538,
            abs_tol=1e-12)

# `tests/test_cds.py:64-126`: the level-2 L2 inside the reference's MPI
# regression digit 0.0000096078 (`d4est_test_mpi.sh:5-10`); after one
# smooth_pred step (32 marked, 288 elements after balance) the converged
# reference driver's L2 (2e-15 absolute) and √Ση² (1e-12 absolute).
CDS = dict(n_elements=(64, 288), local_nodes=(1728, 7776), marked=32,
           l2_0_range=(9.6078e-6, 9.6079e-6),
           l2_1=3.7944365819784e-6, l2_1_abs=2e-15,
           estimator=3.18356715487649e-5, estimator_abs=1e-12,
           residual_norm=1e-12)

# `tests/test_regression_digits.py:131-190`
# (refcheck/two_punctures_probe_13tree.c, dense Newton to 1.3e-16).
TP13 = dict(n_elements=104, local_nodes=832, u_100=0.0001690472493169,
            abs_tol=1e-12, residual_norm=1e-13)

# `tests/test_tp_trajectory.py:55-60` (refcheck/tp_puncture_traj_probe.c):
# (elements, true nodes, Ση², relative tolerance) per level, after the
# level's Newton solve (‖F‖ < 1e-12).
TP_TRAJECTORY = [
    (7, 56, 4.340079487232e-05, 1e-9),
    (7, 75, 5.828146748239e-04, 6e-2),
    (7, 113, 3.926499117213e-04, 1e-2),
    (14, 302, 4.765855e-03, 5e-3),
]
TP_TRAJECTORY_RESIDUAL = 1e-12

# `tests/test_regression_digits.py:312-341` (refcheck/stamm_probe.c):
# (elements, true nodes, L2 of the interpolated |e|, √Ση², L2 relative
# tolerance, estimate relative tolerance); rows 6-7 are the
# `DISCO4EST_DEEP_TESTS` rows, at their deep tolerances.
STAMM = [
    (1, 27, 4.999999999999999e-01, 8.411163231756122e00, 1e-10, 1e-10),
    (8, 216, 1.0275938426558613e-04, 3.4281941578298671e-03, 1e-10, 1e-10),
    (64, 1728, 8.0763868619692208e-06, 8.7418772785858201e-04, 1e-10,
     1e-10),
    (456, 12312, 3.8789115402296782e-06, 2.8744364809238571e-04, 1e-10,
     1e-10),
    (512, 27440, 6.042615297480418e-07, 8.516776762948383e-05, 1e-10,
     1e-10),
    (1352, 95504, 9.43171338940422e-08, 1.773498989361e-05, 5e-10, 5e-10),
    (1520, 141872, 2.9678033363170958e-09, 2.1615679616413724e-06, 5e-9,
     1e-10),
    (1520, 224864, 5.9433721417322740e-10, 2.6015502608406779e-07, 5e-8,
     1e-9),
]


def stamm_row_errors(row, pin):
    """(L2 relative gap, estimate relative gap, counts equal) of one row
    of `tools.oracles.stamm_trajectory` against its pin."""
    E, nodes, l2, est, _, _ = pin
    return (abs(row["l2"] - l2) / l2, abs(row["estimator"] - est) / est,
            (row["n_elements"], row["nodes"]) == (E, nodes))
