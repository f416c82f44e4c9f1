"""The port's nonlinear modules == the JAX package's (f64, CPU).

- `laplacian/nonlinear.py`: `apply_mass_fof`, `apply_mass_fof_lin` and
  `assemble_fof_blocks` on a level-1 brick and a level-1 7-tree sphere,
  to 1e-12 relative;
- `solvers/newton.py`: one small dense problem whose line search
  backtracks: the same iterates, ‖F‖ history (to 1e-12 of the first ‖F‖)
  and callback as JAX's;
- `residual` and `jacobian_apply` of ConstantDensityStar, Okendon,
  TwoPunctures (Robin), MultiPuncture (Robin, three spinning punctures)
  and BoyenYork on one small mesh each, to 1e-12 (CDS on a level-1
  brick, whose Lobatto nodes include the star's center: its 1/r branch
  must not leak there);
- Stamm's `neg_laplacian` at seeded points, to 1e-12;
- `mesh/probe.py`: `locate_point` at seeded points (inside seeded
  elements, where the inversion from r = ½ converges) on the level-0
  compactified 7-tree and 13-tree spheres finds their element and local
  coordinates to 1e-12, and `interpolate_at_point` equals JAX's to 1e-12; the port's probe at (10, 0, 0) on the level-1 7-tree, where
  the point lies on the core/shell interface, timed.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu.geometry.brick import BrickGeometry as JBrick
from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry as JSphere
from disco4est_tpu.mesh.builder import build_mesh as jbuild
from disco4est_tpu.mesh.tree import Forest as JForest
from disco4est_tpu_torch.geometry.brick import BrickGeometry as TBrick
from disco4est_tpu_torch.geometry.cubed_sphere import (
    CubedSphereGeometry as TSphere,
)
from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
from disco4est_tpu_torch.mesh.tree import Forest as TForest

from torch_threads import torch_worker_threads  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _pair(kind, geom_kw, level, deg, **kw):
    jg, tg = ((JBrick, TBrick) if kind == "brick" else (JSphere, TSphere))
    jg, tg = jg(**geom_kw), tg(**geom_kw)
    jf, tf = JForest.uniform(jg.conn, level), TForest.uniform(tg.conn, level)
    return (jbuild(jg, jf, deg=deg, **kw),
            tbuild(tg, tf, deg=deg, device="cpu", **kw))


BRICK = ("brick", dict(dim=3))
# each JAX mesh costs seconds of compiles (its build, then every eager
# operation at its shapes), so the tests share these
MESHES = {
    "brick": lambda: _pair(*BRICK, 1, 2),
    "sphere7": lambda: _pair("sphere", dict(kind="7tree", R0=1.0, R1=2.0),
                             1, 2, deg_quad=3, face_h_type="j_div_sj_quad"),
    # the TwoPunctures domain of the reference's digit
    "tp7": lambda: _pair("sphere", dict(kind="7tree", R0=10.0, R1=1000.0,
                                        compactify_inner_shell=True), 0, 2,
                         deg_quad=3, face_h_type="j_div_sj_min_lobatto"),
}


@pytest.fixture(scope="module")
def meshes():
    built = {}

    def get(key):
        if key not in built:
            built[key] = MESHES[key]()
        return built[key]

    return get


def _field(mesh, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return shift + scale * rng.standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * mesh.dim)


def _fof(lib):
    return lambda xyz, u: lib.sin(xyz[0] + 2.0 * xyz[1]) * u**3 + xyz[2] * u


def _dfof(lib):
    return lambda xyz, u: 3.0 * lib.sin(xyz[0] - xyz[2]) * u**2 + xyz[1]


@pytest.mark.parametrize("key", ["brick", "sphere7"])
def test_mass_fof_terms_match_jax(meshes, key):
    from disco4est_tpu.laplacian import nonlinear as J
    from disco4est_tpu_torch.laplacian import nonlinear as T

    jm, tm = meshes(key)
    u0, v = _field(jm, 1), _field(jm, 2)
    a = T.apply_mass_fof(tm, torch.as_tensor(u0), _fof(torch))
    b = J.apply_mass_fof(jm, jnp.asarray(u0), _fof(jnp))
    assert _rel(a, b) <= 1e-12
    a = T.apply_mass_fof_lin(tm, torch.as_tensor(u0), torch.as_tensor(v),
                             _dfof(torch))
    b = J.apply_mass_fof_lin(jm, jnp.asarray(u0), jnp.asarray(v), _dfof(jnp))
    assert _rel(a, b) <= 1e-12
    a = T.assemble_fof_blocks(tm, torch.as_tensor(u0), _dfof(torch))
    b = J.assemble_fof_blocks(jm, jnp.asarray(u0), _dfof(jnp))
    assert a.shape == (jm.n_elements, jm.nl**3, jm.nl**3)
    assert _rel(a, b) <= 1e-12
    # on a mesh without a radial rule the blocks are the linear term's
    got = torch.einsum("eij,ej->ei", a, torch.as_tensor(v).reshape(
        v.shape[0], -1))
    ref = T.apply_mass_fof_lin(tm, torch.as_tensor(u0), torch.as_tensor(v),
                               _dfof(torch))
    assert _rel(got, ref.reshape(got.shape)) <= 1e-12


def _dense_problem(lib):
    """F(u) = A u + u³ − b on R⁶ and its Jacobian solve (exact, dense)."""
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((6, 6))
    A = lib.asarray(Q @ Q.T + 6.0 * np.eye(6))
    b = lib.asarray(rng.standard_normal(6))

    def residual(u):
        return A @ u + u**3 - b

    def solve(u, rhs, rtol):
        J = A + lib.diag(3.0 * u**2)
        return lib.linalg.solve(J, rhs)

    return residual, solve


def test_newton_matches_jax():
    from disco4est_tpu.solvers import newton as J
    from disco4est_tpu_torch.solvers import newton as T

    u0 = np.full(6, 4.0)  # far out: the first steps backtrack
    runs = {}
    for name, mod, lib in (("jax", J, jnp), ("torch", T, torch)):
        residual, solve = _dense_problem(lib)
        calls, rtols = [], []

        def jsolve(u, rhs, rtol, solve=solve, rtols=rtols):
            rtols.append(rtol)
            return solve(u, rhs, rtol)

        params = mod.NewtonParams(atol=1e-13, max_iter=30)
        res = mod.newton_solve(
            residual, jsolve, lib.asarray(u0), params,
            callback=lambda k, u, f, calls=calls: calls.append((k, f)))
        runs[name] = (res, calls, rtols)
    (rj, cj, tj), (rt, ct, tt) = runs["jax"], runs["torch"]
    assert rt.iterations == rj.iterations >= 4
    assert len(rt.history) == len(rj.history)
    # ‖F‖ to 1e-12 of its start: F cancels terms of that size, so its
    # rounding is absolute, not relative to each later ‖F‖
    for a, b in zip(rt.history, rj.history):
        assert abs(a - b) <= 1e-12 * rj.history[0], (a, b)
    assert [k for k, _ in ct] == [k for k, _ in cj]
    # the forcing terms max(1e-3, min(½, √‖F‖)) of each step
    assert tt == [max(1e-3, min(0.5, f**0.5)) for f in rt.history[:-1]]
    assert np.allclose(tt, tj, rtol=1e-9, atol=0.0)
    assert _rel(rt.u, rj.u) <= 1e-12
    assert rt.residual_norm < 1e-13


def _cds_pair(meshes):
    from disco4est_tpu.problems import constant_density_star as J
    from disco4est_tpu_torch.problems import constant_density_star as T

    jm, tm = meshes("brick")
    pj, pt = J.CDSParams.create(), T.CDSParams.create()
    assert dataclasses.astuple(pt) == dataclasses.astuple(pj)  # bisection
    gj, gt = jm.boundary_values(pj.psi), tm.boundary_values(pt.psi)
    assert _rel(gt, gj) <= 1e-14
    assert np.isfinite(tm.init_field(pt.psi).numpy()).all()
    return dict(
        jax=lambda u: J.residual(jm, u, gj, pj),
        torch=lambda u: T.residual(tm, u, gt, pt),
        jax_jac=lambda u, v: J.jacobian_apply(jm, u, v, pj),
        torch_jac=lambda u, v: T.jacobian_apply(tm, u, v, pt),
        mesh=jm, shift=1.0,
    )


def _okendon_pair(meshes):
    from disco4est_tpu.problems import okendon as J
    from disco4est_tpu_torch.problems import okendon as T

    jm, tm = _pair("brick", dict(x0=(0.2, 0.2, 0.2), x1=(1.0, 1.0, 1.0),
                                 dim=3), 1, 2)
    pj, pt = J.OkendonParams(p=0.5), T.OkendonParams(p=0.5)
    gj, gt = jm.boundary_values(pj.boundary), tm.boundary_values(pt.boundary)
    return dict(
        jax=lambda u: J.residual(jm, u, gj, pj),
        torch=lambda u: T.residual(tm, u, gt, pt),
        jax_jac=lambda u, v: J.jacobian_apply(jm, u, v, pj),
        torch_jac=lambda u, v: T.jacobian_apply(tm, u, v, pt),
        mesh=jm, shift=0.5,
    )


def _punctures_pair(meshes, kind):
    from disco4est_tpu.problems import multi_puncture as JM
    from disco4est_tpu.problems import two_punctures as JT
    from disco4est_tpu_torch.problems import multi_puncture as TM
    from disco4est_tpu_torch.problems import two_punctures as TT

    if kind == "two_punctures":
        jm, tm = meshes("tp7")
        J, T = JT, TT
        pj, pt = JT.TwoPuncturesParams(), TT.TwoPuncturesParams()
    else:
        jm, tm = meshes("sphere7")
        J, T = JM, TM
        args = [((2.0, 0.0, 0.0), 0.4, (0.0, 0.1, 0.0), (0.0, 0.0, 0.1)),
                ((-1.0, 1.7, 0.0), 0.3, (-0.08, -0.05, 0.0),
                 (0.0, 0.05, 0.0)),
                ((-1.0, -1.7, 0.0), 0.3, (0.08, -0.05, 0.0),
                 (0.05, 0.0, 0.0))]
        pj = JM.MultiPunctureParams(punctures=tuple(
            JM.Puncture(xyz=x, M=m, P=p, S=s) for x, m, p, s in args))
        pt = TM.MultiPunctureParams(punctures=tuple(
            TM.Puncture(xyz=x, M=m, P=p, S=s) for x, m, p, s in args))
    rj = jm.boundary_values_quad(pj.robin_coeff)
    rt = tm.boundary_values_quad(pt.robin_coeff)
    assert _rel(rt, rj) <= 1e-14
    return dict(
        jax=lambda u: J.residual(jm, u, pj, rj),
        torch=lambda u: T.residual(tm, u, pt, rt),
        jax_jac=lambda u, v: J.jacobian_apply(jm, u, v, pj, rj),
        torch_jac=lambda u, v: T.jacobian_apply(tm, u, v, pt, rt),
        mesh=jm, shift=0.0, scale=0.01,
    )


def _boyen_york_pair(meshes):
    from disco4est_tpu.problems import boyen_york as J
    from disco4est_tpu_torch.problems import boyen_york as T

    jm, tm = _pair("sphere", dict(kind="12tree_hole", R0=1.5, R1=2.0,
                                  R2=4.0), 0, 2, face_h_type="j_div_sj_quad",
                   penalty_fcn="meanp_sqr_over_meanh")
    pj, pt = J.BoyenYorkParams(a=1.0, P=1.0), T.BoyenYorkParams(a=1.0, P=1.0)
    gj, gt = jm.boundary_values(pj.boundary), tm.boundary_values(pt.boundary)
    return dict(
        jax=lambda u: J.residual(jm, u, gj, pj),
        torch=lambda u: T.residual(tm, u, gt, pt),
        jax_jac=lambda u, v: J.jacobian_apply(jm, u, v, pj),
        torch_jac=lambda u, v: T.jacobian_apply(tm, u, v, pt),
        mesh=jm, shift=1.5,
    )


PROBLEMS = {
    "cds": _cds_pair,
    "okendon": _okendon_pair,
    "two_punctures": lambda meshes: _punctures_pair(meshes, "two_punctures"),
    "multi_puncture": lambda meshes: _punctures_pair(meshes,
                                                     "multi_puncture"),
    "boyen_york": _boyen_york_pair,
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_problem_residual_and_jacobian_match_jax(meshes, name):
    p = PROBLEMS[name](meshes)
    scale = p.get("scale", 0.1)
    u = _field(p["mesh"], 4, scale=scale, shift=p["shift"])
    v = _field(p["mesh"], 5)
    a = p["torch"](torch.as_tensor(u))
    b = p["jax"](jnp.asarray(u))
    assert np.isfinite(a.numpy()).all()
    assert _rel(a, b) <= 1e-12
    a = p["torch_jac"](torch.as_tensor(u), torch.as_tensor(v))
    b = p["jax_jac"](jnp.asarray(u), jnp.asarray(v))
    assert _rel(a, b) <= 1e-12


def test_stamm_neg_laplacian_matches_jax():
    from disco4est_tpu.problems.stamm import StammProblem as J
    from disco4est_tpu_torch.problems.stamm import StammProblem as T

    rng = np.random.default_rng(7)
    pts = rng.uniform(0.0, 1.0, (3, 5, 4))
    pts[:, 0, 0] = 0.5  # the singular point: 0 in both (masked NaN)
    for c in ((0.5, 0.5, 0.5), (0.3, 0.6, 0.45)):
        jp, tp = J(c=c), T(c=c)
        a = tp.rhs(*torch.as_tensor(pts))
        b = jp.rhs(*jnp.asarray(pts))
        assert a.shape == (5, 4)
        assert _rel(a, b) <= 1e-12
        assert _rel(tp.analytic(*torch.as_tensor(pts)),
                    jp.analytic(*jnp.asarray(pts))) <= 1e-14
    assert float(T().rhs(*torch.full((3, 1), 0.5))[0]) == 0.0


def _probe_points(mesh, rng, n):
    """n seeded elements, local points in their middle (where the
    inversion from r = ½, which both packages start from, converges) and
    the physical points there."""
    from disco4est_tpu_torch.mesh.tree import ROOT

    f = mesh.forest
    elems = rng.choice(mesh.n_elements, n, replace=False)
    r = rng.uniform(0.3, 0.7, (n, 3))
    rst = f.anchor[elems] / ROOT + 2.0 ** -f.level[elems][:, None] * r
    xyz = mesh.geom.x(torch.as_tensor(f.tree[elems].astype(np.int64)),
                      torch.as_tensor(rst)).numpy()
    return elems, r, xyz


@pytest.mark.parametrize("kind", ["7tree", "13tree"])
def test_probe_matches_jax(meshes, kind):
    """`locate_point` finds the element and local point each physical
    point came from (the only element holding it, so the one JAX's scan
    returns; JAX's eager scan takes seconds a candidate), and the values
    equal JAX's `interpolate_at_point` from that element."""
    from disco4est_tpu.mesh import probe as J
    from disco4est_tpu_torch.mesh import probe as T

    if kind == "7tree":
        jm, tm = meshes("tp7")
    else:
        jm, tm = _pair("sphere", dict(kind="13tree", R0=10.0, R1=20.0,
                                      R2=1000.0, compactify_outer_shell=True),
                       0, 1, face_h_type="j_div_sj_quad")
    u = _field(jm, 8)
    elems, rs, pts = _probe_points(tm, np.random.default_rng(11), 2)
    for k, (e0, r0, xyz) in enumerate(zip(elems, rs, pts)):
        e, r = T.locate_point(tm, xyz)
        assert e == e0
        assert np.max(np.abs(r - r0)) <= 1e-12
        vt, e = T.interpolate_at_point(tm, torch.as_tensor(u), xyz)
        assert e == e0
        vf, _ = T.interpolate_at_point(tm, torch.as_tensor(u), xyz,
                                       element=e0)
        assert vf == vt
        if k == 0:
            vj, _ = J.interpolate_at_point(jm, jnp.asarray(u), xyz,
                                           element=int(e0))
            assert abs(vt - vj) <= 1e-12 * max(1.0, abs(vj))


def test_probe_on_the_core_shell_interface_is_quick():
    """(10, 0, 0) on the level-1 7-tree (R0 = 10) lies on the core/shell
    interface, so several elements are candidates; the port inverts them
    together."""
    from disco4est_tpu_torch.mesh import probe as T

    geom = TSphere(kind="7tree", R0=10.0, R1=1000.0,
                   compactify_inner_shell=True)
    mesh = tbuild(geom, TForest.uniform(geom.conn, 1), deg=2, device="cpu",
                  face_h_type="j_div_sj_min_lobatto")
    u = mesh.init_field(lambda x, y, z: x + 2.0 * y - z)
    t0 = time.perf_counter()
    val, e = T.interpolate_at_point(mesh, u, (10.0, 0.0, 0.0))
    assert time.perf_counter() - t0 < 20.0
    # the element holds the point, and its (curved) deg-2 interpolant of
    # x + 2y − z is near the value 10 there
    x = mesh.xyz_lobatto[e].reshape(3, -1).numpy()
    assert x[0].min() - 1e-9 <= 10.0 <= x[0].max() + 1e-9
    assert abs(val - 10.0) <= 0.5


# --- the mass kernel's gate and operand checks (`csrc/mass_apply.cu` runs
# only on a card; tests/test_torch_kernel.py holds it to the plain path)


def _port_mesh(key):
    from disco4est_tpu_torch.geometry.cubed_sphere import CubedSphereGeometry

    level, kw = 0, {}
    if key == "compactified":  # a per-element radial rule
        geom = CubedSphereGeometry(kind="13tree", R0=1.0, R1=2.0, R2=10.0,
                                   compactify_outer_shell=True)
        kw = dict(deg=2, deg_quad=2, compactified_k=4)
    else:
        geom = TBrick(dim=2 if key == "brick2d" else 3)
        level = 1
        kw = dict(brick=dict(deg=2), brick2d=dict(deg=2),
                  deg8=dict(deg=8), quad_plus3=dict(deg=2, deg_quad=5))[key]
    return tbuild(geom, TForest.uniform(geom.conn, level), device="cpu", **kw)


# whether the kernel has an instance for the mesh (f64)
MASS_MESHES = {"brick": True, "brick2d": True, "compactified": False,
               "deg8": False, "quad_plus3": False}


@pytest.mark.parametrize("key", sorted(MASS_MESHES))
def test_mass_coeff_on_the_cpu_is_the_plain_path(key):
    """On CPU tensors `apply_mass_coeff` is today's plain expression bit
    for bit and launches nothing; the kernel's gate takes the meshes it
    has an instance for and no other."""
    from disco4est_tpu_torch.laplacian import nonlinear as T
    from disco4est_tpu_torch.mesh.builder import vol_interp

    mesh = _port_mesh(key)
    assert T.mass_kernel_fits(mesh, torch.float64) is MASS_MESHES[key]
    assert T.mass_kernel_fits(mesh, torch.float32) is MASS_MESHES[key]
    assert not T.mass_kernel_fits(mesh, torch.float16)
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * mesh.dim))
    coeff = torch.as_tensor(rng.standard_normal(
        (mesh.n_elements,) + (mesh.deg_quad + 1,) * mesh.dim))
    before = T.KERNEL_LAUNCHES
    got = T.apply_mass_coeff(mesh, coeff, v)
    ref = vol_interp(mesh, coeff * vol_interp(mesh, v), transpose=True)
    assert T.KERNEL_LAUNCHES == before
    assert torch.equal(got, ref)


def _meta(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


# each case: (v, coeff) on the deg-2 level-1 brick (E 8, n 3, nq 3)
MASS_OPERANDS_BAD = {
    "mixed_types": lambda: (_meta(8, 3, 3, 3, dtype=torch.float32),
                            _meta(8, 3, 3, 3)),
    "half": lambda: (_meta(8, 3, 3, 3, dtype=torch.float16),
                     _meta(8, 3, 3, 3, dtype=torch.float16)),
    "coeff_shape": lambda: (_meta(8, 3, 3, 3), _meta(8, 4, 4, 4)),
    "v_shape": lambda: (_meta(8, 27), _meta(8, 3, 3, 3)),
    "v_not_contiguous": lambda: (_meta(8, 3, 3, 3).transpose(1, 2),
                                 _meta(8, 3, 3, 3)),
    "coeff_not_contiguous": lambda: (_meta(8, 3, 3, 3),
                                     _meta(3, 8, 3, 3).transpose(0, 1)),
    "devices": lambda: (_meta(8, 3, 3, 3),
                        torch.zeros((8, 3, 3, 3), dtype=torch.float64)),
}


@pytest.mark.parametrize("case", sorted(MASS_OPERANDS_BAD))
def test_mass_kernel_operand_checks_raise(case):
    """The kernel wrapper's operand check, on meta tensors (no card):
    right operands give (E, n, nq), each wrong one raises ValueError, and
    the wrapper refuses CPU tensors before any launch."""
    from disco4est_tpu_torch.laplacian import nonlinear as T

    mesh = _port_mesh("brick")
    assert T.check_mass_operands(mesh, _meta(8, 3, 3, 3),
                                 _meta(8, 3, 3, 3)) == (8, 3, 3)
    v, coeff = MASS_OPERANDS_BAD[case]()
    with pytest.raises(ValueError):
        T.check_mass_operands(mesh, coeff, v)
    with pytest.raises(ValueError, match="no instance"):
        T.check_mass_operands(_port_mesh("deg8"), _meta(1, 9, 9, 9),
                              _meta(1, 9, 9, 9))
    with pytest.raises(ValueError, match="CUDA"):
        T.mass_apply_cuda(mesh, torch.zeros(8, 3, 3, 3, dtype=torch.float64),
                          torch.zeros(8, 3, 3, 3, dtype=torch.float64))
