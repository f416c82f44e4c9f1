"""The port's Krylov preconditioning pieces == the JAX package's (f64, CPU).

The same inputs, made from a numpy seed, go through each JAX function and
its port; meshes are built by both packages from the same forests:

- `cg_eigs` and `power_method` to 1e-10 relative; `cheby_smooth` to
  1e-12; `cg_solve` / `fcg_solve` with a preconditioner `M` and
  `mixed_refine_solve` with `M32` to 1e-10;
- `assemble_diag_blocks` and `BlockSchwarz` to 1e-12;
- `build_hierarchy`'s tables (`src`, `bits`, `copy`) and level degrees
  exactly equal on a uniform 3D brick, the hanging forest of
  `tests/test_multigrid.py:97` and an hp mesh;
- `prolong`, `restrict`, `restrict_blocks`: to 1e-13 relative, and the
  fixed-order sums against `index_add` (their JAX form) to 1e-13;
- one `v_cycle` for every smoother × bottom plugin on the brick, and the
  default plugins on the hanging and hp meshes, to 1e-10 relative; the
  Newton-MG matrix operator (`set_matrix_operator`) to 1e-13;
- the frozen-update bottom CG equals the stopped `cg_solve` bit for bit;
- the cases of `tests/test_multigrid.py` through the port, on the same
  meshes, Newton-MG on CDS included (the overlapping-Schwarz smoother's
  in `tests/test_torch_schwarz.py`);
- the coarse levels take the fine mesh's penalty options; the JAX
  `build_hierarchy` takes `build_mesh`'s defaults (ROADMAP C12);
- `gmres_solve` and the diagnostics (`full_matrix`, `matrix_symmetry`,
  `jacobian_test`) to 1e-10.

Tolerances: every comparison is of f64 contractions of the same tables in
another order; a V-cycle amplifies rounding through its Chebyshev
recurrences and bottom CG, hence 1e-10 there.
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
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / (scale if scale > 0 else 1.0))


def _forests(case):
    """(JAX geometry, port geometry, JAX forest, port forest, deg, deg_e)."""
    from disco4est_tpu.geometry.brick import BrickGeometry as JB
    from disco4est_tpu.mesh.tree import ROOT
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB
    from disco4est_tpu_torch.mesh.tree import Forest as TF

    jg, tg = JB(dim=3), TB(dim=3)
    if case == "uniform":
        return jg, tg, JF.uniform(jg.conn, 2), TF.uniform(tg.conn, 2), 2, None
    jf, tf = JF.uniform(jg.conn, 1), TF.uniform(tg.conn, 1)
    if case == "hanging":  # `tests/test_multigrid.py:97`
        for _ in range(2):
            flags = np.all(jf.anchor / ROOT < 0.3, axis=1)
            jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
        return jg, tg, jf, tf, 2, None
    flags = np.zeros(8, bool)  # hp: `tests/test_multigrid.py:296`
    flags[0] = True
    jf, tf = jf.refine(flags).balance(), tf.refine(flags).balance()
    deg_e = np.full(jf.n_elements, 2, np.int32)
    deg_e[:4] = 3
    return jg, tg, jf, tf, 3, deg_e


_MESHES = {}


def meshes(case):
    """JAX and port meshes of one case, built once per module."""
    if case not in _MESHES:
        from disco4est_tpu.mesh.builder import build_mesh as jbuild
        from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild

        jg, tg, jf, tf, deg, deg_e = _forests(case)
        _MESHES[case] = (jbuild(jg, jf, deg=deg, deg_e=deg_e),
                         tbuild(tg, tf, deg=deg, deg_e=deg_e, device="cpu"))
    return _MESHES[case]


def _field(mesh, seed, own=False):
    from disco4est_tpu_torch.laplacian.hp import own_mask

    r = np.random.default_rng(seed).standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * mesh.dim)
    return r * own_mask(mesh).numpy() if own else r


def _ops(case):
    from disco4est_tpu.laplacian.hp import apply_sipg_hp as jhp
    from disco4est_tpu.laplacian.sipg import apply_sipg as ja
    from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp as thp
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg as ta

    return (jhp, thp) if case == "hp" else (ja, ta)


def _seeds():
    import jax.numpy as jnp

    return (lambda m: m.init_field(lambda *c: sum(jnp.sin(3 * x) for x in c)),
            lambda m: m.init_field(lambda *c: sum(torch.sin(3 * x)
                                                  for x in c)))


# ---------------------------------------------------------------------------
# eigs, Chebyshev, the Krylov solvers' M
# ---------------------------------------------------------------------------


def test_cg_eigs_and_power_method_match_jax():
    import jax.numpy as jnp

    from disco4est_tpu.laplacian.sipg import apply_sipg as ja
    from disco4est_tpu.solvers import eigs as je
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg as ta
    from disco4est_tpu_torch.solvers import eigs as te

    jm, tm = meshes("uniform")
    b = _field(tm, 0)
    jl = je.cg_eigs(lambda v: ja(jm, v), jnp.asarray(b), 10)
    tl = te.cg_eigs(lambda v: ta(tm, v), torch.as_tensor(b), 10)
    for x, y in zip(tl, jl):
        assert abs(x - float(y)) <= 1e-10 * abs(float(y)), (tl, jl)
    jp = je.power_method(lambda v: ja(jm, v), jnp.asarray(b), 30)
    tp = te.power_method(lambda v: ta(tm, v), torch.as_tensor(b), 30)
    assert abs(float(tp) - float(jp)) <= 1e-10 * abs(float(jp))


def test_cheby_smooth_and_solve_match_jax():
    import jax.numpy as jnp

    from disco4est_tpu.laplacian.sipg import apply_sipg as ja
    from disco4est_tpu.solvers import cheby as jc
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg as ta
    from disco4est_tpu_torch.solvers import cheby as tc

    jm, tm = meshes("uniform")
    b, x = _field(tm, 1), _field(tm, 2)
    A_j, A_t = (lambda v: ja(jm, v)), (lambda v: ta(tm, v))
    out_j = jc.cheby_smooth(A_j, jnp.asarray(b), jnp.asarray(x), 0.05, 1.5, 8)
    out_t = tc.cheby_smooth(A_t, torch.as_tensor(b), torch.as_tensor(x),
                            0.05, 1.5, 8)
    assert _rel(out_t.numpy(), out_j) <= 1e-12
    assert _rel(tc.cheby_solve(A_t, torch.as_tensor(b)).numpy(),
                jc.cheby_solve(A_j, jnp.asarray(b))) <= 1e-12


def test_krylov_preconditioner_arguments_match_jax():
    """`cg_solve(M=)` and `fcg_solve(M=)` with a Chebyshev preconditioner
    take JAX's iteration counts and iterates; `mixed_refine_solve(M32=)`
    reaches the f64 floor with the same counts."""
    import jax.numpy as jnp

    from disco4est_tpu.laplacian.sipg import apply_sipg as ja
    from disco4est_tpu.solvers import cg as jcg
    from disco4est_tpu.solvers import cheby as jc
    from disco4est_tpu.solvers import fcg as jfcg
    from disco4est_tpu.solvers import mixed as jmx
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg as ta
    from disco4est_tpu_torch.solvers import cg as tcg
    from disco4est_tpu_torch.solvers import cheby as tc
    from disco4est_tpu_torch.solvers import fcg as tfcg
    from disco4est_tpu_torch.solvers import mixed as tmx

    jm, tm = meshes("uniform")
    b = _field(tm, 3)
    A_j, A_t = (lambda v: ja(jm, v)), (lambda v: ta(tm, v))
    M_j = lambda r: jc.cheby_smooth(A_j, r, jnp.zeros_like(r), 0.1, 3.0, 4)
    M_t = lambda r: tc.cheby_smooth(A_t, r, torch.zeros_like(r), 0.1, 3.0, 4)
    for js, ts in ((jcg.cg_solve, tcg.cg_solve),
                   (jfcg.fcg_solve, tfcg.fcg_solve)):
        rj = js(A_j, jnp.asarray(b), M=M_j, atol=1e-12, rtol=0.0,
                max_iter=300)
        rt = ts(A_t, torch.as_tensor(b), M=M_t, atol=1e-12, rtol=0.0,
                max_iter=300)
        assert rt.iterations == int(rj.iterations) < 100
        assert _rel(rt.x.numpy(), rj.x) <= 1e-10
    M32_j = lambda r: jc.cheby_smooth(
        lambda v: ja(jm, v.astype(jnp.float64)).astype(jnp.float32), r,
        jnp.zeros_like(r), 0.1, 3.0, 4)
    M32_t = lambda r: tc.cheby_smooth(
        lambda v: ta(tm, v.double()).float(), r, torch.zeros_like(r), 0.1,
        3.0, 4)
    rj = jmx.mixed_refine_solve(A_j, jnp.asarray(b), M32=M32_j)
    rt = tmx.mixed_refine_solve(A_t, torch.as_tensor(b), M32=M32_t)
    assert rt.outer_iterations == int(rj.outer_iterations)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-10


# ---------------------------------------------------------------------------
# block Schwarz
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["uniform", "hanging"])
def test_diag_blocks_and_block_schwarz_match_jax(case):
    import jax.numpy as jnp

    from disco4est_tpu.solvers import schwarz as js
    from disco4est_tpu_torch.solvers import schwarz as ts

    jm, tm = meshes(case)
    jb = js.assemble_diag_blocks(jm)
    tb = ts.assemble_diag_blocks(tm)
    assert _rel(tb.numpy(), jb) <= 1e-12
    r = _field(tm, 4)
    jM, tM = js.BlockSchwarz.setup(jm), ts.BlockSchwarz.setup(tm)
    assert _rel(tM(torch.as_tensor(r)).numpy(), jM(jnp.asarray(r))) <= 1e-12


# ---------------------------------------------------------------------------
# the hierarchy and its transfers
# ---------------------------------------------------------------------------


_HIER = {}


def hierarchies(case):
    if case not in _HIER:
        from disco4est_tpu.solvers import multigrid as jmg
        from disco4est_tpu_torch.solvers import multigrid as tmg

        jm, tm = meshes(case)
        _HIER[case] = (jmg.build_hierarchy(jm), tmg.build_hierarchy(tm))
    return _HIER[case]


@pytest.mark.parametrize("case", ["uniform", "hanging", "hp"])
def test_hierarchy_tables_match_jax(case):
    jh, th = hierarchies(case)
    assert th.n_levels == jh.n_levels >= 3 and th.hp == jh.hp == (case == "hp")
    for jl, tl in zip(jh.maps, th.maps):
        np.testing.assert_array_equal(tl.src_np, np.asarray(jl.src))
        np.testing.assert_array_equal(tl.bits_np, np.asarray(jl.bits))
        np.testing.assert_array_equal(tl.copy_np, np.asarray(jl.copy))
        assert tl.n_coarse == jl.n_coarse
    for jm, tm in zip(jh.meshes, th.meshes):
        np.testing.assert_array_equal(tm.deg_e.numpy(), np.asarray(jm.deg_e))
        assert _rel(tm.sigma.numpy(), jm.sigma) <= 1e-13


def _index_add_restrict(lm, contrib, n_coarse):
    """The JAX form of the coarse sum: rows added into their parents."""
    out = torch.zeros((n_coarse,) + contrib.shape[1:], dtype=contrib.dtype)
    return out.index_add(0, lm.src, contrib)


@pytest.mark.parametrize("case", ["uniform", "hanging"])
def test_transfers_match_jax_and_index_add(case):
    import jax.numpy as jnp

    from disco4est_tpu.solvers import multigrid as jmg
    from disco4est_tpu_torch.solvers import multigrid as tmg

    jh, th = hierarchies(case)
    deg, dim = th.meshes[0].deg, 3
    n = (deg + 1) ** dim
    for level, (jl, tl) in enumerate(zip(jh.maps, th.maps)):
        nc = th.meshes[level + 1].n_elements
        nf = th.meshes[level].n_elements
        uc = _field(th.meshes[level + 1], 10 + level)
        rf = _field(th.meshes[level], 20 + level)
        assert _rel(tmg.prolong(tl, torch.as_tensor(uc), deg, dim).numpy(),
                    jmg.prolong(jl, jnp.asarray(uc), deg, dim)) <= 1e-13
        rc = tmg.restrict(tl, torch.as_tensor(rf), deg, dim, nc)
        assert _rel(rc.numpy(), jmg.restrict(jl, jnp.asarray(rf), deg, dim,
                                             nc)) <= 1e-13
        # the fixed-order sum against index_add of the same rows: each
        # row's P_cᵀ r is its restriction onto a coarse slot of its own
        own = tmg.MGLevelMap(np.arange(nf), tl.bits_np, tl.copy_np, nf)
        contrib = tmg.restrict(own, torch.as_tensor(rf), deg, dim, nf)
        assert _rel(rc.numpy(),
                    _index_add_restrict(tl, contrib, nc).numpy()) <= 1e-13
        B = np.random.default_rng(30 + level).standard_normal((nf, n, n))
        Bc = tmg.restrict_blocks(tl, torch.as_tensor(B), deg, dim, nc)
        assert _rel(Bc.numpy(), jmg.restrict_blocks(jl, jnp.asarray(B), deg,
                                                    dim, nc)) <= 1e-13
        P = tmg.prolong_mats(tl, deg, dim, torch.float64)
        PtBP = P.transpose(1, 2) @ torch.as_tensor(B) @ P
        assert _rel(Bc.numpy(),
                    _index_add_restrict(tl, PtBP, nc).numpy()) <= 1e-13


def test_hierarchy_from_numpy_runs_on_jax_tables():
    """The port's transfers on the JAX package's own tables equal them on
    the port's."""
    from disco4est_tpu_torch.solvers import multigrid as tmg

    jh, th = hierarchies("hanging")
    maps = [dict(src=np.asarray(m.src), bits=np.asarray(m.bits),
                 copy=np.asarray(m.copy), n_coarse=m.n_coarse)
            for m in jh.maps]
    h2 = tmg.hierarchy_from_numpy(th.meshes, maps, bounds=[(0.1, 1.0)] * 4)
    r = torch.as_tensor(_field(th.meshes[0], 5))
    for a, b in zip(h2.maps, th.maps):
        nc = int(a.slots.shape[0])
        assert torch.equal(tmg.restrict(a, r, 2, 3, nc),
                           tmg.restrict(b, r, 2, 3, nc))
        r = tmg.restrict(a, r, 2, 3, nc)


# ---------------------------------------------------------------------------
# the V-cycle
# ---------------------------------------------------------------------------


SMOOTHERS = ["cheby", "schwarz", "schwarz_overlap", "none"]
BOTTOMS = ["cg", "cheby", "reuse_smoother"]


def _vcycles(case, smoother="cheby", bottom="cg", nl_blocks=False):
    import jax.numpy as jnp

    from disco4est_tpu.solvers import multigrid as jmg
    from disco4est_tpu_torch.solvers import multigrid as tmg

    jm, tm = meshes(case)
    jop, top = _ops(case)
    jseed, tseed = _seeds()
    kw = dict(smoother=smoother, bottom=bottom)
    jh = jmg.build_hierarchy(jm, jmg.MGParams(**kw))
    th = tmg.build_hierarchy(tm, tmg.MGParams(**kw))
    if nl_blocks:
        n = tm.nl ** 3
        rng = np.random.default_rng(7)
        G = rng.standard_normal((tm.n_elements, n, n)) * 0.01
        B = G @ G.transpose(0, 2, 1)  # small SPD blocks
        jmg.set_matrix_operator(jh, jnp.asarray(B))
        tmg.set_matrix_operator(th, torch.as_tensor(B))
        for a, b in zip(th.nl_blocks, jh.nl_blocks):
            assert _rel(a.numpy(), b) <= 1e-13
    jb = jmg.mg_setup(jh, jop, jseed)
    tb = tmg.mg_setup(th, top, tseed)
    for (_, a), (_, b) in zip(tb, jb):
        assert abs(a - float(b)) <= 1e-10 * abs(float(b))
    r = _field(tm, 6, own=case == "hp")
    vj = jmg.v_cycle(jh, jop, jnp.asarray(r), jnp.zeros(r.shape))
    vt = tmg.v_cycle(th, top, torch.as_tensor(r),
                     torch.zeros(r.shape, dtype=torch.float64))
    return vt.numpy(), np.asarray(vj)


@pytest.mark.parametrize("bottom", BOTTOMS)
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_vcycle_every_plugin_matches_jax(smoother, bottom):
    vt, vj = _vcycles("uniform", smoother, bottom)
    if smoother == "none" and bottom == "reuse_smoother":
        assert not vt.any() and not vj.any()  # no smoothing anywhere
    else:
        assert _rel(vt, vj) <= 1e-10


@pytest.mark.parametrize("case", ["hanging", "hp"])
def test_vcycle_hanging_and_hp_match_jax(case):
    vt, vj = _vcycles(case)
    assert _rel(vt, vj) <= 1e-10


def test_newton_mg_matrix_operator_matches_jax():
    vt, vj = _vcycles("uniform", "schwarz", "cg", nl_blocks=True)
    assert _rel(vt, vj) <= 1e-10


def test_bottom_cg_equals_the_stopped_cg():
    """The fixed-count bottom CG whose updates freeze once the stopping
    test holds returns the stopped `cg_solve`'s iterate bit for bit, with
    the test met before the count runs out and also with the count as
    the limit."""
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.solvers.cg import cg_solve
    from disco4est_tpu_torch.solvers.multigrid import bottom_cg

    _, tm = meshes("uniform")
    A = lambda v: apply_sipg(tm, v)
    b = torch.as_tensor(_field(tm, 8))
    x0 = torch.as_tensor(_field(tm, 9)) * 1e-2
    for rtol, iters in ((1e-6, 100), (1e-30, 7)):
        res = cg_solve(A, b, x0=x0, atol=0.0, rtol=rtol, max_iter=iters)
        assert (res.iterations < iters) == (rtol == 1e-6)
        assert torch.equal(bottom_cg(A, b, x0, rtol, iters), res.x)


# ---------------------------------------------------------------------------
# the cases of tests/test_multigrid.py through the port
# ---------------------------------------------------------------------------


def _setup_2d():
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian.sipg import build_rhs_with_strong_bc
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    geom = BrickGeometry(dim=2)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 3), deg=2,
                      device="cpu")
    u = lambda x, y: torch.sin(np.pi * x) * torch.sin(np.pi * y)
    f = mesh.init_field(lambda x, y: 2 * np.pi**2 * u(x, y))
    return mesh, build_rhs_with_strong_bc(mesh, f, mesh.boundary_values(u))


def _sin_seed(m):
    return m.init_field(lambda *c: sum(torch.sin(3 * x) for x in c))


@pytest.mark.parametrize("name", [
    "hierarchy_depth", "vcycle_contraction", "mg_preconditioned_cg",
    "mg_smoother_plugins", "hanging_3d_deep_lineage",
    "prolong_restrict_adjoint_deep", "matrix_operator_galerkin",
    "hp_multigrid_preconditions_fcg", "newton_mg_cds",
])
def test_jax_multigrid_case_through_the_port(name):
    """The assertions of `tests/test_multigrid.py`, each on the port (its
    overlapping-Schwarz smoother case is in `test_torch_schwarz.py`)."""
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.solvers import multigrid as tmg
    from disco4est_tpu_torch.solvers.cg import cg_solve
    from disco4est_tpu_torch.solvers.fcg import fcg_solve

    if name in ("hierarchy_depth", "vcycle_contraction",
                "mg_preconditioned_cg", "mg_smoother_plugins"):
        mesh, rhs = _setup_2d()
        if name == "hierarchy_depth":
            h = tmg.build_hierarchy(mesh)
            assert h.n_levels == 4 and h.meshes[-1].n_elements == 1
            return
        if name == "vcycle_contraction":
            h = tmg.build_hierarchy(mesh, tmg.MGParams(vcycle_imax=8,
                                                       vcycle_rtol=1e-30))
            tmg.mg_setup(h, apply_sipg, _sin_seed)
            _, hist = tmg.mg_solve(h, apply_sipg, rhs)
            assert hist[2] / hist[1] < 0.2, hist
            return
        if name == "mg_smoother_plugins":
            h = tmg.build_hierarchy(mesh, tmg.MGParams(
                vcycle_imax=10, vcycle_rtol=1e-30, smoother="schwarz",
                bottom="reuse_smoother", schwarz_iterations=4))
            tmg.mg_setup(h, apply_sipg, _sin_seed)
            _, hist = tmg.mg_solve(h, apply_sipg, rhs)
            assert hist[2] / hist[1] < 0.6, hist
            return
        h = tmg.build_hierarchy(mesh)
        tmg.mg_setup(h, apply_sipg, _sin_seed)
        A = lambda v: apply_sipg(mesh, v)
        res = cg_solve(A, rhs, M=tmg.mg_preconditioner(h, apply_sipg),
                       atol=1e-12, rtol=1e-30, max_iter=100)
        plain = cg_solve(A, rhs, atol=1e-12, rtol=1e-30, max_iter=2000)
        assert res.iterations < 25 and res.iterations * 3 < plain.iterations
        assert float((res.x - plain.x).abs().max()) < 1e-8
        return

    if name == "newton_mg_cds":
        # CDS Newton with MG-preconditioned CG on the frozen-u0 matrix
        # operator (boundary data 1, as the JAX test has them)
        from disco4est_tpu_torch.geometry.brick import BrickGeometry
        from disco4est_tpu_torch.laplacian.nonlinear import (
            assemble_fof_blocks,
        )
        from disco4est_tpu_torch.mesh.builder import build_mesh
        from disco4est_tpu_torch.mesh.tree import Forest
        from disco4est_tpu_torch.problems import constant_density_star as cds
        from disco4est_tpu_torch.solvers.newton import (
            NewtonParams,
            newton_solve,
        )

        params = cds.CDSParams.create()
        geom = BrickGeometry(dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, 2), deg=2,
                          device="cpu")
        g = mesh.boundary_values(lambda *c: torch.ones_like(c[0]))
        u0 = mesh.init_field(params.initial_guess)
        h = tmg.build_hierarchy(mesh)
        runs = {}
        for pc in (True, False):
            its = []

            def jac_solve(u0_, rhs_, rtol, pc=pc, its=its):
                M = None
                if pc:
                    tmg.set_matrix_operator(h, assemble_fof_blocks(
                        mesh, u0_, cds.dfof(params)))
                    tmg.mg_setup(h, apply_sipg, _sin_seed)
                    M = tmg.mg_preconditioner(h, apply_sipg)
                res = cg_solve(
                    lambda v: cds.jacobian_apply(mesh, u0_, v, params),
                    rhs_, M=M, atol=0.0, rtol=rtol,
                    max_iter=200 if pc else 5000)
                its.append(res.iterations)
                return res.x

            res = newton_solve(lambda u: cds.residual(mesh, u, g, params),
                               jac_solve, u0,
                               NewtonParams(atol=1e-11, max_iter=12))
            runs[pc] = (res, its)
        (pc_res, pc_its), (plain_res, plain_its) = runs[True], runs[False]
        assert pc_res.residual_norm < 1e-11 and max(pc_its) < 20, pc_its
        assert float((pc_res.u - plain_res.u).abs().max()) < 1e-9
        assert max(pc_its) * 3 < max(plain_its), (pc_its, plain_its)
        return

    if name == "hp_multigrid_preconditions_fcg":
        from disco4est_tpu_torch.laplacian.hp import (
            apply_sipg_hp,
            build_rhs_with_strong_bc_hp,
        )

        _, mesh = meshes("hp")
        assert mesh.hc_elem.shape[0] > 0
        u = lambda x, y, z: (torch.sin(np.pi * x) * torch.sin(np.pi * y)
                             * torch.sin(np.pi * z))
        f = mesh.init_field(lambda x, y, z: 3 * np.pi**2 * u(x, y, z))
        rhs = build_rhs_with_strong_bc_hp(mesh, f, mesh.boundary_values(u))
        h = tmg.build_hierarchy(mesh)
        assert h.hp and h.n_levels >= 2
        lm, dc = h.maps[0], h.meshes[1].deg_e.numpy()
        for c in range(h.meshes[1].n_elements):
            assert dc[c] == mesh.deg_e.numpy()[lm.src_np == c].min()
        tmg.mg_setup(h, apply_sipg_hp, _sin_seed)
        A = lambda v: apply_sipg_hp(mesh, v)
        pc = fcg_solve(A, rhs, M=tmg.mg_preconditioner(h, apply_sipg_hp),
                       atol=1e-12, rtol=0.0, max_iter=200)
        plain = fcg_solve(A, rhs, atol=1e-12, rtol=0.0, max_iter=2000)
        assert pc.residual_norm < 1e-11
        assert pc.iterations < 0.5 * plain.iterations
        return

    # the hanging 3D forest of `tests/test_multigrid.py:97`
    _, mesh = meshes("hanging")
    assert mesh.hc_elem.shape[0] > 0
    h = tmg.build_hierarchy(mesh, tmg.MGParams(vcycle_imax=14,
                                               vcycle_rtol=1e-30))
    lm, nc, Ef = h.maps[0], h.meshes[1].n_elements, mesh.n_elements
    rng = np.random.default_rng(0)
    if name == "hanging_3d_deep_lineage":
        assert h.n_levels >= 3
        tmg.mg_setup(h, apply_sipg, _sin_seed)
        u = lambda x, y, z: (torch.sin(np.pi * x) * torch.sin(np.pi * y)
                             * torch.sin(np.pi * z))
        f = mesh.init_field(lambda x, y, z: 3 * np.pi**2 * u(x, y, z))
        rhs = build_rhs_with_strong_bc(mesh, f, mesh.boundary_values(u))
        _, hist = tmg.mg_solve(h, apply_sipg, rhs)
        rates = [hist[i + 1] / hist[i] for i in range(len(hist) - 1)]
        assert max(rates[1:]) < 0.75, rates
        assert hist[-1] < 3e-4 * hist[0], hist
    elif name == "prolong_restrict_adjoint_deep":
        uc = torch.as_tensor(rng.standard_normal((nc, 3, 3, 3)))
        rf = torch.as_tensor(rng.standard_normal((Ef, 3, 3, 3)))
        a = float(torch.sum(tmg.prolong(lm, uc, 2, 3) * rf))
        b = float(torch.sum(uc * tmg.restrict(lm, rf, 2, 3, nc)))
        assert abs(a - b) < 1e-10 * max(1.0, abs(a))
    else:  # matrix_operator_galerkin: PᵀBP == restrict ∘ B ∘ prolong
        rng = np.random.default_rng(1)
        B = torch.as_tensor(rng.standard_normal((Ef, 27, 27)))
        Bc = tmg.restrict_blocks(lm, B, 2, 3, nc)
        uc = torch.as_tensor(rng.standard_normal((nc, 3, 3, 3)))
        lhs = (Bc @ uc.reshape(nc, -1, 1)).reshape(uc.shape)
        uf = tmg.prolong(lm, uc, 2, 3)
        Buf = (B @ uf.reshape(Ef, -1, 1)).reshape(uf.shape)
        np.testing.assert_allclose(
            lhs.numpy(), tmg.restrict(lm, Buf, 2, 3, nc).numpy(), atol=1e-10)


def test_coarse_levels_take_the_fine_penalty_options():
    """ROADMAP C12: the JAX `build_hierarchy` rebuilds the coarse levels
    with `build_mesh`'s default penalty options (prefactor 2,
    maxp_sqr_over_minh, volume/area face h) whatever the fine mesh used;
    the port's takes the fine mesh's (`mesh_kwargs`, as the driver passes
    them).  On a FACE_H_EQ_TREE_H brick the JAX coarse σ differ from the
    fine-option ones by 33 %; without `mesh_kwargs` the port's equal
    JAX's."""
    from disco4est_tpu.geometry.brick import BrickGeometry as JB
    from disco4est_tpu.mesh.builder import build_mesh as jbuild
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu.solvers import multigrid as jmg
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB
    from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
    from disco4est_tpu_torch.mesh.tree import Forest as TF
    from disco4est_tpu_torch.solvers import multigrid as tmg

    jg, tg = JB(dim=3), TB(dim=3)
    kw = dict(face_h_type="tree_h", penalty_prefactor=3.0)
    jm = jbuild(jg, JF.uniform(jg.conn, 2), deg=2, **kw)
    tm = tbuild(tg, TF.uniform(tg.conn, 2), deg=2, device="cpu", **kw)
    jh = jmg.build_hierarchy(jm)
    th = tmg.build_hierarchy(tm, mesh_kwargs=kw)
    plain = tmg.build_hierarchy(tm)
    for level in (1, 2):
        fine_opts = tbuild(tg, th.meshes[level].forest, deg=2, device="cpu",
                           **kw).sigma.numpy()
        np.testing.assert_array_equal(th.meshes[level].sigma.numpy(),
                                      fine_opts)
        np.testing.assert_allclose(plain.meshes[level].sigma.numpy(),
                                   np.asarray(jh.meshes[level].sigma),
                                   rtol=1e-13)
        gap = np.abs(np.asarray(jh.meshes[level].sigma) / fine_opts - 1)
        assert 0.3 < gap.max() < 0.4, gap.max()


# ---------------------------------------------------------------------------
# GMRES and the diagnostics
# ---------------------------------------------------------------------------


def test_gmres_matches_jax():
    import jax.numpy as jnp

    from disco4est_tpu.laplacian.sipg import apply_sipg as ja
    from disco4est_tpu.solvers import gmres as jgm
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg as ta
    from disco4est_tpu_torch.solvers import gmres as tgm
    from disco4est_tpu_torch.solvers.schwarz import BlockSchwarz

    from disco4est_tpu.solvers.schwarz import BlockSchwarz as JBS

    jm, tm = meshes("uniform")
    b = _field(tm, 11)
    for M in (False, True):
        kw_j = dict(M=JBS.setup(jm)) if M else {}
        kw_t = dict(M=BlockSchwarz.setup(tm)) if M else {}
        rj = jgm.gmres_solve(lambda v: ja(jm, v), jnp.asarray(b), restart=20,
                             max_restarts=10, atol=1e-10, rtol=0.0, **kw_j)
        rt = tgm.gmres_solve(lambda v: ta(tm, v), torch.as_tensor(b),
                             restart=20, max_restarts=10, atol=1e-10,
                             rtol=0.0, **kw_t)
        assert rt.iterations == int(rj.iterations)
        assert _rel(rt.x.numpy(), rj.x) <= 1e-10
        assert abs(rt.residual_norm - float(rj.residual_norm)) <= 1e-10


def test_diagnostics_match_jax():
    import jax.numpy as jnp

    from disco4est_tpu.laplacian.sipg import apply_sipg as ja
    from disco4est_tpu.problems import constant_density_star as jcds
    from disco4est_tpu.solvers import diagnostics as jd
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg as ta
    from disco4est_tpu_torch.problems import constant_density_star as tcds
    from disco4est_tpu_torch.solvers import diagnostics as td

    from disco4est_tpu.geometry.brick import BrickGeometry as JB
    from disco4est_tpu.mesh.builder import build_mesh as jbuild
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB
    from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild
    from disco4est_tpu_torch.mesh.tree import Forest as TF

    jg, tg = JB(dim=3), TB(dim=3)
    jm = jbuild(jg, JF.uniform(jg.conn, 1), deg=1)
    tm = tbuild(tg, TF.uniform(tg.conn, 1), deg=1, device="cpu")
    shape = (8, 2, 2, 2)
    Mj = jd.full_matrix(lambda v: ja(jm, v), shape)
    Mt = td.full_matrix(lambda v: ta(tm, v), shape)
    assert _rel(Mt, Mj) <= 1e-10
    sj = jd.matrix_symmetry(lambda v: ja(jm, v), shape)
    st = td.matrix_symmetry(lambda v: ta(tm, v), shape)
    assert st[0] and sj[0]
    assert abs(st[1] - sj[1]) <= 1e-10 * np.abs(Mj).max()

    jp, tp = jcds.CDSParams.create(), tcds.CDSParams.create()
    g_j = jm.boundary_values(jp.psi)
    g_t = tm.boundary_values(tp.psi)
    u0 = tm.init_field(tp.initial_guess).numpy()
    wj = jd.jacobian_test(
        lambda u: jcds.residual(jm, u, g_j, jp),
        lambda u, v: jcds.jacobian_apply(jm, u, v, jp), jnp.asarray(u0))
    wt = td.jacobian_test(
        lambda u: tcds.residual(tm, u, g_t, tp),
        lambda u, v: tcds.jacobian_apply(tm, u, v, tp), torch.as_tensor(u0))
    assert wt < 1e-6 and abs(wt - wj) <= 1e-10
