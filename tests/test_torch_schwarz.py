"""The port's overlapping Schwarz (`solvers/schwarz_overlap.py`) == the JAX
package's (f64, CPU), and the reference's Schwarz trajectory through it.

- `subdomain_members` (with the probe directions) and the tables
  (`member`, `valid`, `mask`, `weight`) exactly equal on a brick, a
  hanging brick and the 7-tree sphere (membership: no JAX mesh needed);
- on an 18-tree brick the JAX membership is wrong, its packed leaf key
  wrapping tree ids of 16 and above (ROADMAP C8); the port's equals the
  geometric vertex patches;
- `_schwarz_apply` to 1e-11 relative at 8 subdomain CG iterations, and
  on the JAX package's own tables (`schwarz_from_numpy`) equal to the
  port's own tables.  The fixed-count subdomain CG has no stopping test:
  once a subdomain (a few dozen DOF at one overlap layer) has converged,
  its further steps are driven by rounding noise, and the two packages'
  applies, equal to 1e-13 at 8 iterations, drift apart (measured on the
  hanging brick, one layer: 1.4e-10 at 12, 2.8e-8 at 15, 2.6e-5 at 30);
- the reference's Schwarz regression digit 0.15228638 and its 10-iterate
  trajectory (`tests/test_regression_digits.py:193-266`, the pinned
  reference values; no JAX rerun) to the bounds there;
- the cases of `tests/test_schwarz_overlap.py` (dense definition, 2D
  membership sizes, FCG preconditioning, smoothing) and the
  overlapping-Schwarz multigrid smoother of `tests/test_multigrid.py`,
  through the port.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _forests(case):
    from disco4est_tpu.geometry.brick import BrickGeometry as JB
    from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry as JS
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB
    from disco4est_tpu_torch.geometry.cubed_sphere import (
        CubedSphereGeometry as TS,
    )
    from disco4est_tpu_torch.mesh.tree import Forest as TF

    if case == "sphere7":
        jg, tg = JS("7tree", R0=1.0, R1=2.0), TS("7tree", R0=1.0, R1=2.0)
        jf, tf = JF.uniform(jg.conn, 1), TF.uniform(tg.conn, 1)
        flags = np.zeros(jf.n_elements, bool)
        flags[[0, 9, 30]] = True
        return jg, tg, jf.refine(flags).balance(), tf.refine(flags).balance()
    jg, tg = JB(dim=3), TB(dim=3)
    jf, tf = JF.uniform(jg.conn, 1), TF.uniform(tg.conn, 1)
    if case == "hanging":
        flags = np.zeros(8, bool)
        flags[0] = True
        jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    return jg, tg, jf, tf


@pytest.mark.parametrize("case", ["brick", "hanging", "sphere7"])
def test_members_match_jax(case):
    from disco4est_tpu.solvers import schwarz_overlap as jso
    from disco4est_tpu_torch.solvers import schwarz_overlap as tso

    _, _, jf, tf = _forests(case)
    jm, jrel = jso.subdomain_members(jf, return_rel=True)
    tm, trel = tso.subdomain_members(tf, return_rel=True)
    assert len(tm) == len(jm) == tf.n_elements
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    assert trel == jrel
    if case == "hanging":
        assert max(len(m) for m in tm) > 8  # fine neighbors on coarse faces


def _meshes(case, deg=2):
    from disco4est_tpu.mesh.builder import build_mesh as jbuild
    from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild

    jg, tg, jf, tf = _forests(case)
    return jbuild(jg, jf, deg=deg), tbuild(tg, tf, deg=deg, device="cpu")


@pytest.mark.parametrize("ov", [1, 2])
@pytest.mark.parametrize("case", ["brick", "hanging"])
def test_tables_and_apply_match_jax(case, ov):
    import jax.numpy as jnp

    from disco4est_tpu.solvers import schwarz_overlap as jso
    from disco4est_tpu_torch.solvers import schwarz_overlap as tso

    jm, tm = _meshes(case)
    js = jso.build_overlapping_schwarz(jm, num_nodes_overlap=ov,
                                       iterations=8)
    ts = tso.build_overlapping_schwarz(tm, num_nodes_overlap=ov,
                                       iterations=8)
    for name in ("member", "valid", "mask", "weight"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    r = np.random.default_rng(ov).standard_normal((tm.n_elements, 3, 3, 3))
    got = ts(torch.as_tensor(r))
    assert _rel(got.numpy(), js(jnp.asarray(r))) <= 1e-11
    # the port's apply on the JAX package's own tables
    ts2 = tso.schwarz_from_numpy(tm, np.asarray(js.member),
                                 np.asarray(js.valid), np.asarray(js.mask),
                                 np.asarray(js.weight), iterations=8)
    assert torch.equal(ts2(torch.as_tensor(r)), got)


def _vertex_patches(mesh):
    """Each element and every element whose closed box touches its own,
    from the element corners (an affine brick)."""
    x = mesh.xyz_lobatto.reshape(mesh.n_elements, mesh.dim, -1).numpy()
    lo, hi = x.min(axis=2), x.max(axis=2)
    eps = 1e-12
    touch = np.all((lo[:, None] <= hi[None] + eps)
                   & (lo[None] <= hi[:, None] + eps), axis=2)
    return [np.where(row)[0] for row in touch]


def test_18_tree_brick_membership_differs_from_jax():
    """ROADMAP C8: on a brick of 3 × 3 × 2 trees the JAX membership
    (`schwarz_overlap.py:45,108`, the packed key of `mesh/tree.py:_key_of`)
    finds wrong leaves for trees 16 and 17; the port's equals the
    geometric vertex patches everywhere."""
    from disco4est_tpu.geometry.brick import BrickGeometry as JB
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu.solvers import schwarz_overlap as jso
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest as TF
    from disco4est_tpu_torch.solvers import schwarz_overlap as tso

    kw = dict(x1=(3.0, 3.0, 2.0), n_trees_per_dim=(3, 3, 2), dim=3)
    jf, tf = JF.uniform(JB(**kw).conn, 1), TF.uniform(TB(**kw).conn, 1)
    mesh = build_mesh(TB(**kw), tf, deg=1, device="cpu")
    want = _vertex_patches(mesh)
    tm = tso.subdomain_members(tf)
    for a, b in zip(tm, want):
        np.testing.assert_array_equal(a, b)
    jm = jso.subdomain_members(jf)
    wrong = [e for e, (a, b) in enumerate(zip(jm, want))
             if not np.array_equal(a, b)]
    assert wrong, "the JAX membership is right on 18 trees"
    assert set(tf.tree[wrong]) & {15, 16, 17}


def test_schwarz_digit_trajectory():
    """The reference's Schwarz regression digit `0.15228638`
    (`Tests/Regression/d4est_test_schwarz.sh:5`) and the 10-iterate
    trajectory of `tests/test_regression_digits.py:193-266` (values from
    the reference harness): 13-tree sphere R0 1/3, R1 2/3, R2 1, level 0,
    deg 4, FACE_H_EQ_J_DIV_SJ_QUAD, num_nodes_overlap 4, 400 subdomain CG
    iterations; u₀ = 0, u ← u + M(b − A u)."""
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
    )

    geom = CubedSphereGeometry("13tree", R0=1.0 / 3.0, R1=2.0 / 3.0, R2=1.0)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 0), deg=4, deg_quad=4,
                      penalty_prefactor=2.0, penalty_fcn="maxp_sqr_over_minh",
                      face_h_type="j_div_sj_quad", device="cpu")
    assert mesh.n_elements == 13
    poly = lambda x, y, z: torch.exp(x + y + z) * (x * x + y * y + z * z - 1)
    neglap = lambda x, y, z: -torch.exp(x + y + z) * (
        3.0 + x * (4.0 + 3.0 * x) + y * (4.0 + 3.0 * y) + z * (4.0 + 3.0 * z))
    rhs = build_rhs_with_strong_bc(mesh, mesh.init_field(neglap),
                                   mesh.boundary_values(poly))
    sol = mesh.init_field(poly)
    M = build_overlapping_schwarz(mesh, num_nodes_overlap=4, iterations=400)
    ref = [
        (11.029811440762897, 0.152286388792538),
        (8.478311301990601, 0.030824293450190),
        (2.004390543675700, 0.006973281993397),
        (0.389316550646736, 0.001661047758643),
        (0.076353915252118, 0.000406316495572),
        (0.015850377445150, 0.000101033279923),
        (0.003495337566975, 0.000025513862237),
        (0.000810831051224, 0.000006726003428),
        (0.000195525821702, 0.000002099298702),
        (0.000048528414143, 0.000000952418865),
    ]
    u = torch.zeros_like(rhs)
    for i, (r2_ref, l2_ref) in enumerate(ref):
        r = rhs - apply_sipg(mesh, u)
        r2 = float(torch.sum(r * r))
        u = u + M(r)
        l2 = float(torch.sum(mesh.l2_norm_sqr(torch.abs(sol - u))))
        # the reference values are %.15f prints
        assert abs(r2 - r2_ref) < max(1e-11 * r2_ref, 2e-15), (i, r2, r2_ref)
        assert abs(l2 - l2_ref) < max(1e-9 * l2_ref, 2e-15), (i, l2, l2_ref)
    assert "0.15228638" in f"{ref[0][1]:.15f}"


# ---------------------------------------------------------------------------
# the cases of tests/test_schwarz_overlap.py through the port
# ---------------------------------------------------------------------------


def _brick(dim, level, hanging=False):
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    geom = BrickGeometry(dim=dim)
    forest = Forest.uniform(geom.conn, level)
    if hanging:
        flags = np.zeros(forest.n_elements, bool)
        flags[0] = True
        forest = forest.refine(flags).balance()
    return build_mesh(geom, forest, deg=2, device="cpu")


@pytest.mark.parametrize("hanging", [False, True])
@pytest.mark.parametrize("ov", [1, 2])
def test_schwarz_matches_dense_definition(hanging, ov):
    """Σ_s R_sᵀ W_s A_s⁻¹ R_s r with dense subdomain solves, 2D."""
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers.diagnostics import full_matrix
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
    )

    mesh = _brick(2, 1, hanging)
    E, n = mesh.n_elements, mesh.nl**2
    shape = (E, mesh.nl, mesh.nl)
    A = full_matrix(lambda v: apply_sipg(mesh, v), shape)
    s = build_overlapping_schwarz(mesh, num_nodes_overlap=ov, iterations=400)
    r = np.random.default_rng(0).standard_normal(shape)
    got = s(torch.as_tensor(r)).numpy()
    member, valid = s.member.numpy(), s.valid.numpy()
    mask = s.mask.numpy().reshape(member.shape + (n,))
    weight = s.weight.numpy().reshape(member.shape + (n,))
    want = np.zeros((E, n))
    for si in range(E):
        dofs = [(k, member[si, k], j) for k in range(member.shape[1])
                if valid[si, k] for j in np.where(mask[si, k] > 0.5)[0]]
        g = np.array([e * n + j for _, e, j in dofs])
        e_s = np.linalg.solve(A[np.ix_(g, g)], r.reshape(-1)[g])
        for (k, e, j), val in zip(dofs, e_s):
            want[e, j] += weight[si, k, j] * val
    assert np.abs(got.reshape(E, n) - want).max() < 1e-8 * max(
        np.abs(want).max(), 1.0)


def test_members_conforming_2d():
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.solvers.schwarz_overlap import subdomain_members

    sizes = np.array([len(m) for m in subdomain_members(
        Forest.uniform(BrickGeometry(dim=2).conn, 2))])
    assert sizes.min() == 4 and sizes.max() == 9 and (sizes == 9).sum() == 4


def _sin_problem(mesh):
    from disco4est_tpu_torch.laplacian.sipg import build_rhs_with_strong_bc

    u = lambda x, y, z: (torch.sin(np.pi * x) * torch.sin(np.pi * y)
                         * torch.sin(np.pi * z))
    f = mesh.init_field(lambda x, y, z: 3 * np.pi**2 * u(x, y, z))
    return build_rhs_with_strong_bc(mesh, f, mesh.boundary_values(u))


def test_schwarz_preconditions_fcg_3d():
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers.fcg import fcg_solve
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
    )

    mesh = _brick(3, 2)
    rhs = _sin_problem(mesh)
    A = lambda v: apply_sipg(mesh, v)
    plain = fcg_solve(A, rhs, atol=1e-11, rtol=0.0, max_iter=400)
    M = build_overlapping_schwarz(mesh, num_nodes_overlap=2, iterations=20)
    pc = fcg_solve(A, rhs, M=M, atol=1e-11, rtol=0.0, max_iter=400)
    assert pc.iterations < 0.5 * plain.iterations
    assert float((A(pc.x) - rhs).abs().max()) < 1e-9


def test_schwarz_smoother_contracts():
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers.schwarz_overlap import (
        build_overlapping_schwarz,
        overlap_schwarz_smooth,
    )

    mesh = _brick(2, 2)
    M = build_overlapping_schwarz(mesh, num_nodes_overlap=1, iterations=10)
    A = lambda v: apply_sipg(mesh, v)
    b = A(torch.as_tensor(np.random.default_rng(1).standard_normal(
        (mesh.n_elements, 3, 3))))
    x = overlap_schwarz_smooth(A, M, b, torch.zeros_like(b), iterations=3)
    assert float(torch.linalg.norm(b - A(x))) < 0.2 * float(
        torch.linalg.norm(b))


def test_mg_overlapping_schwarz_smoother():
    """`tests/test_multigrid.py:366` through the port: the overlapping
    Schwarz as the V-cycle's smoother preconditions FCG."""
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers import multigrid as tmg
    from disco4est_tpu_torch.solvers.fcg import fcg_solve

    mesh = _brick(3, 2)
    rhs = _sin_problem(mesh)
    h = tmg.build_hierarchy(mesh, tmg.MGParams(
        smoother="schwarz_overlap", schwarz_iterations=2,
        schwarz_overlap_nodes=2, schwarz_subdomain_iters=30))
    tmg.mg_setup(h, apply_sipg, lambda m: m.init_field(
        lambda *c: sum(torch.sin(3 * x) for x in c)))
    assert h.smoother_state is not None
    A = lambda v: apply_sipg(mesh, v)
    pc = fcg_solve(A, rhs, M=tmg.mg_preconditioner(h, apply_sipg),
                   atol=1e-11, rtol=0.0, max_iter=100)
    plain = fcg_solve(A, rhs, atol=1e-11, rtol=0.0, max_iter=1000)
    assert pc.residual_norm < 1e-10
    assert pc.iterations < 0.4 * plain.iterations

