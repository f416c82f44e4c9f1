"""The port's distributed modules (`disco4est_tpu_torch/parallel/`) == the
JAX package's `disco4est_tpu/parallel/` and the port's global operators.

- `sfc_partition`, `PaddedLayout`, `pad_mesh_to_layout` and
  `build_halo_program` tables equal JAX's entry by entry (index tables
  exactly, f64 factors to 1e-13: the two builders' meshes agree to that)
  on a conforming brick, a hanging brick, an hp mesh, the 7-tree sphere
  with the pointwise penalty and an adapted 7-tree sphere;
- the halo apply, driven for N = 1, 2, 4, 8 ranks in lockstep in one
  process (pack, the exchange by hand, compute), equals JAX's
  `apply_sipg_halo` / `apply_sipg_hp_halo` on the 8 virtual devices and
  the port's global `apply_sipg` / `apply_sipg_hp` to 1e-12 relative
  (f64), its pad rows exactly zero (`tests/test_halo.py`,
  `test_distributed_amr.py`);
- under `ThreadGroup` (N ranks as threads, the global dots): the sharded
  transfers, bounds and V-cycle equal the port's global ones, the level
  transfer tables JAX's (`tests/test_mg_sharded.py`), and a distributed
  CG step after an AMR epoch is rank-count invariant
  (`test_amr_epoch_device_count_invariance`);
- `migrate_after_amr` round-trips and equals the host transfer and JAX's.
"""

import numpy as np
import pytest
import torch

from disco4est_tpu_torch.parallel import comm as C
from disco4est_tpu_torch.parallel import halo as H
from disco4est_tpu_torch.parallel import mg as PMG
from disco4est_tpu_torch.parallel import repartition as R
from disco4est_tpu_torch.parallel.sharding import shard_field, shard_mesh_data

from torch_threads import run_thread_ranks, torch_worker_threads  # noqa: F401

KINDS = ["brick", "hanging", "hp", "sphere", "sphere_hanging"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / (scale if scale > 0 else 1.0))


def _forests(kind):
    """(JAX geometry, port geometry, JAX forest, port forest)."""
    if kind.startswith("sphere"):
        from disco4est_tpu.geometry.cubed_sphere import CubedSphereGeometry
        from disco4est_tpu_torch.geometry.cubed_sphere import (
            CubedSphereGeometry as TS,
        )

        jg = CubedSphereGeometry("7tree", R0=1.0, R1=2.0)
        tg = TS("7tree", R0=1.0, R1=2.0)
        flags = [3, 17] if kind == "sphere_hanging" else []
        level = 1
    else:
        from disco4est_tpu.geometry.brick import BrickGeometry
        from disco4est_tpu_torch.geometry.brick import BrickGeometry as TB

        jg, tg = BrickGeometry(dim=3), TB(dim=3)
        flags = [] if kind == "brick" else [0, 9, 33]
        level = 2
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu_torch.mesh.tree import Forest as TF

    jf, tf = JF.uniform(jg.conn, level), TF.uniform(tg.conn, level)
    if flags:
        fl = np.zeros(jf.n_elements, bool)
        fl[flags] = True
        jf, tf = jf.refine(fl).balance(), tf.refine(fl).balance()
    if kind in ("hanging", "hp"):
        # `tests/test_distributed_amr.py:_hanging_mesh`: E divisible by 8
        E = jf.n_elements
        k = (7 * ((-E) % 8)) % 8
        if k:
            fl = np.zeros(E, bool)
            fl[np.where(jf.level == jf.level.min())[0][-k:]] = True
            jf, tf = jf.refine(fl).balance(), tf.refine(fl).balance()
    return jg, tg, jf, tf


_MESHES = {}


def meshes(kind):
    """JAX and port meshes of one kind, built once per module."""
    if kind not in _MESHES:
        from disco4est_tpu.mesh.builder import build_mesh as jbuild
        from disco4est_tpu_torch.mesh.builder import build_mesh as tbuild

        jg, tg, jf, tf = _forests(kind)
        kw = dict(deg=2)
        if kind == "hp":
            kw = dict(deg=3, deg_e=np.random.default_rng(11).integers(
                2, 4, size=jf.n_elements).astype(np.int32))
        if kind.startswith("sphere"):
            kw["face_h_type"] = "j_div_sj_quad"
        _MESHES[kind] = (jbuild(jg, jf, **kw), tbuild(tg, tf, device="cpu",
                                                      **kw))
    return _MESHES[kind]


def _weights(mesh):
    return (mesh.deg_e.cpu().numpy() + 1) ** mesh.dim


def _field(mesh, seed, own=False):
    from disco4est_tpu_torch.laplacian.hp import own_mask

    r = np.random.default_rng(seed).standard_normal(
        (mesh.n_elements,) + (mesh.nl,) * mesh.dim)
    return r * own_mask(mesh).numpy() if own else r


# ---------------------------------------------------------------------------
# the communicator
# ---------------------------------------------------------------------------


def test_comm_world_backend_and_collectives():
    env = dict(WORLD_SIZE="4", RANK="2", LOCAL_RANK="2", MASTER_ADDR="h",
               MASTER_PORT="1234")
    assert C.world_from_env(env) == C.World(2, 4, 2, 4, "tcp://h:1234")
    jax_env = dict(DISCO4EST_NUM_PROCESSES="2", DISCO4EST_PROCESS_ID="1",
                   DISCO4EST_COORDINATOR="host0:99")
    assert C.world_from_env(jax_env) == C.World(1, 2, 1, 2,
                                                "tcp://host0:99")
    assert C.world_from_env({}) == C.World()
    with pytest.raises(ValueError, match="MASTER_PORT"):
        C.world_from_env(dict(WORLD_SIZE="2", RANK="0"))
    # NCCL cannot put two ranks on one card, nor serve CPU ranks: it
    # raises and names gloo, never switches
    with pytest.raises(ValueError, match="backend = gloo"):
        C.check_backend("nccl", torch.device("cpu"), C.World(0, 2, 0, 2))
    with pytest.raises(ValueError, match="not one of"):
        C.check_backend("mpi", torch.device("cpu"), C.World(0, 2, 0, 2))
    C.check_backend("gloo", torch.device("cpu"), C.World(0, 2, 0, 2))
    # auto takes gloo unless every rank on the host has a card of its own;
    # an explicit name is checked and kept
    cpu = torch.device("cpu")
    assert C.resolve_backend("auto", cpu, C.World(0, 2, 0, 2)) == "gloo"
    assert C.resolve_backend("gloo", cpu, C.World(0, 2, 0, 2)) == "gloo"
    with pytest.raises(ValueError, match="backend = gloo"):
        C.resolve_backend("nccl", cpu, C.World(0, 2, 0, 2))

    parts = torch.tensor([1e16, 1.0, -1e16, 1.0, 3.0], dtype=torch.float64)
    assert float(C.pairwise_sum(parts)) == ((1e16 + 1.0) + (-1e16 + 1.0)
                                            ) + 3.0

    def rank(comm):
        send = torch.stack([torch.full((2,), 10.0 * comm.rank + j)
                            for j in range(comm.size)])
        recv = comm.exchange(send)
        a = torch.arange(3.0) + comm.rank
        return (recv, comm.dot(a, a), comm.all_gather_rows(a[None]),
                comm.broadcast(np.array([comm.rank])))

    out = run_thread_ranks(3, rank)
    for r, (recv, d, rows, b) in enumerate(out):
        assert recv[:, 0].tolist() == [10.0 * j + r for j in range(3)]
        assert float(d) == float(out[0][1]) == 5.0 + 14.0 + 29.0
        assert rows.shape == (3, 3) and b.tolist() == [0]


# ---------------------------------------------------------------------------
# partition, layout, padded mesh and halo tables against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_partition_and_layout_match_jax(n):
    from disco4est_tpu.parallel import repartition as JR

    deg_e = np.random.default_rng(0).integers(1, 5, size=1000)
    w = (deg_e + 1) ** 3
    counts = R.sfc_partition(w, n)
    np.testing.assert_array_equal(counts, JR.sfc_partition(w, n))
    assert counts.sum() == 1000
    # per-rank node weight within 1.35x of the ideal (contiguous cuts;
    # `tests/test_distributed_amr.py:test_sfc_partition_balances_nodes`)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    per = np.array([w[bounds[s]:bounds[s + 1]].sum() for s in range(n)])
    assert per.max() < 1.35 * w.sum() / n
    lay, jlay = R.PaddedLayout.build(w, n), JR.PaddedLayout.build(w, n)
    assert (lay.n_dev, lay.Bmax) == (jlay.n_dev, jlay.Bmax)
    np.testing.assert_array_equal(lay.src, jlay.src)
    np.testing.assert_array_equal(lay.counts, jlay.counts)


_INT = ("deg_e", "nbr_elem", "nbr_face", "bnd_mask", "conf_mask",
        "orient_code", "hc_elem", "hc_fine")
_FLOAT = ("wjgg", "face_drst", "face_n", "face_sj", "sigma", "sigma_q",
          "j_quad", "xyz_lobatto")


@pytest.mark.parametrize("kind", KINDS)
def test_padded_mesh_and_halo_tables_match_jax(kind):
    from disco4est_tpu.parallel.halo import build_halo_program as jbuild
    from disco4est_tpu.parallel.repartition import (
        PaddedLayout as JL,
        pad_mesh_to_layout as jpad,
    )

    jm, tm = meshes(kind)
    w = _weights(tm)
    for n in (2, 8):
        jp, tp = jpad(jm, JL.build(w, n)), R.pad_mesh_to_layout(
            tm, R.PaddedLayout.build(w, n))
        for f in _INT:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)), f)
        for f in _FLOAT:
            if getattr(jp, f) is not None:
                assert _rel(getattr(tp, f).numpy(), getattr(jp, f)) <= 1e-13
        with pytest.raises(AttributeError, match="padded"):
            tp.forest.level  # noqa: B018
        jh, th = jbuild(jp, n), H.build_halo_program(tp, n)
        for f in ("B", "H", "K", "Mc", "Mf", "n_dev"):
            assert getattr(th, f) == getattr(jh, f), f
        for f in ("send_idx", "recv_pos", "nbr_local"):
            np.testing.assert_array_equal(getattr(th, f),
                                          np.asarray(getattr(jh, f)), f)
        assert _rel(th.halo_face_drst.numpy(), jh.halo_face_drst) <= 1e-13
        assert set(th.hang) == (set(H.HANG_FIELDS) if jh.Mc else set())
        for f, v in th.hang.items():
            ref = np.asarray(getattr(jh, f))
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, ref, f)
            else:
                assert _rel(v.numpy(), ref) <= 1e-13, f
    if kind in ("hanging", "sphere_hanging"):
        assert th.Mc > 0 and th.Mf > 0


# ---------------------------------------------------------------------------
# the lockstep halo apply
# ---------------------------------------------------------------------------


def lockstep_apply(mesh, u, n, hp=False, robin=None):
    """The halo apply on n ranks driven in lockstep: every rank packs, the
    blocks are exchanged by hand, every rank computes.  Returns the result
    in global order and the padded result (pad rows included)."""
    from disco4est_tpu_torch.laplacian.hp import adjoint_to_own, to_max

    lay = R.PaddedLayout.build(_weights(mesh), n)
    mp = R.pad_mesh_to_layout(mesh, lay)
    prog = H.build_halo_program(mp, n)
    ms = [shard_mesh_data(mp, r, n) for r in range(n)]
    hs = [prog.local(r) for r in range(n)]
    ul = [shard_field(R.migrate_field(u, lay), r, n) for r in range(n)]
    rc = [None if robin is None else
          shard_field(R.migrate_field(robin, lay), r, n) for r in range(n)]
    if hp:
        ul = [to_max(m, v) for m, v in zip(ms, ul)]
    sends = [H.halo_pack(hs[r], ul[r]) for r in range(n)]
    outs = [H.halo_compute(ms[r], hs[r], ul[r],
                           torch.stack([sends[s][r] for s in range(n)]),
                           rc[r]) for r in range(n)]
    if hp:
        outs = [adjoint_to_own(m, v) for m, v in zip(ms, outs)]
    padded = torch.cat(outs)
    return R.unmigrate_field(padded, lay, mesh.n_elements), padded, lay


_JAX_HALO = {}


def jax_halo_apply(kind, u):
    """JAX's shard_map halo apply on the 8 virtual devices, through a
    padded node-weighted layout (`tests/test_distributed_amr.py`)."""
    import jax
    import jax.numpy as jnp

    from disco4est_tpu.parallel import halo as JH
    from disco4est_tpu.parallel import repartition as JR
    from disco4est_tpu.parallel.sharding import (
        element_mesh,
        shard_field as jshard_field,
        shard_mesh_data as jshard,
    )

    jm, tm = meshes(kind)
    lay = JR.PaddedLayout.build(_weights(tm), 8)
    mp = JR.pad_mesh_to_layout(jm, lay)
    dev_mesh = element_mesh(jax.devices()[:8])
    prog = JH.build_halo_program(mp, 8)
    fn = JH.apply_sipg_hp_halo if kind == "hp" else JH.apply_sipg_halo
    out = jax.jit(lambda m, h, v: fn(m, h, v, dev_mesh))(
        jshard(mp, dev_mesh), prog,
        jshard_field(JR.migrate_field(jnp.asarray(u), lay), dev_mesh))
    return np.asarray(JR.unmigrate_field(out, lay, jm.n_elements))


@pytest.mark.parametrize("kind", KINDS)
def test_lockstep_halo_apply_matches_jax_and_global(kind):
    from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg

    jm, tm = meshes(kind)
    hp = kind == "hp"
    u = _field(tm, 3, own=hp)
    ref = jax_halo_apply(kind, u)
    glob = (apply_sipg_hp if hp else apply_sipg)(tm, torch.as_tensor(u))
    assert _rel(glob.numpy(), ref) <= 1e-12
    for n in (1, 2, 4, 8):
        out, padded, lay = lockstep_apply(tm, torch.as_tensor(u), n, hp=hp)
        assert _rel(out.numpy(), ref) <= 1e-12, n
        assert _rel(out.numpy(), glob.numpy()) <= 1e-12, n
        assert not padded[torch.as_tensor(lay.src < 0)].any(), n


@pytest.mark.parametrize("kind", ["robin", "compactified", "disk"])
def test_lockstep_halo_apply_options(kind):
    """Robin data on the adapted sphere, the compactified radial rule
    (which the JAX halo apply does not take: it has no radial rule) and a
    2D hanging disk, against the port's global apply."""
    from disco4est_tpu_torch.laplacian.sipg import apply_sipg
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    robin = None
    if kind == "robin":
        mesh = meshes("sphere_hanging")[1]
        robin = mesh.boundary_values_quad(
            lambda x, y, z: 1.0 / torch.sqrt(x * x + y * y + z * z))
    elif kind == "compactified":
        from disco4est_tpu_torch.geometry.cubed_sphere import (
            CubedSphereGeometry,
        )

        geom = CubedSphereGeometry("13tree", R0=10.0, R1=20.0, R2=1000.0,
                                   compactify_outer_shell=True)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, 1), deg=2,
                          face_h_type="j_div_sj_quad", compactified_k=4,
                          device="cpu")
        assert mesh.rad_interp is not None
    else:
        from disco4est_tpu_torch.geometry.disk import DiskGeometry

        geom = DiskGeometry(R0=0.5, R1=1.0)
        forest = Forest.uniform(geom.conn, 2)
        fl = np.zeros(forest.n_elements, bool)
        fl[[1, 6]] = True
        mesh = build_mesh(geom, forest.refine(fl).balance(), deg=3,
                          face_h_type="j_div_sj_quad", device="cpu")
        assert mesh.hc_elem.shape[0] > 0
    u = torch.as_tensor(_field(mesh, 5))
    ref = apply_sipg(mesh, u, robin_coeff=robin)
    for n in (1, 3, 4):
        out, padded, lay = lockstep_apply(mesh, u, n, robin=robin)
        assert _rel(out.numpy(), ref.numpy()) <= 1e-12, n
        assert not padded[torch.as_tensor(lay.src < 0)].any(), n


# ---------------------------------------------------------------------------
# the shard-resident multigrid under ThreadGroup
# ---------------------------------------------------------------------------

_HIER = {}


def hierarchies(kind):
    """The port's hierarchy of one mesh, bounds installed by the global
    `mg_setup`, and its operator (one per module)."""
    if kind not in _HIER:
        from disco4est_tpu_torch.laplacian.hp import apply_sipg_hp
        from disco4est_tpu_torch.laplacian.sipg import apply_sipg
        from disco4est_tpu_torch.solvers import multigrid as tmg

        tm = meshes(kind)[1]
        params = tmg.MGParams(n_smooth=3, eigs_cg_iters=5)
        th = tmg.build_hierarchy(tm, params)
        op = apply_sipg_hp if th.hp else apply_sipg
        tmg.mg_setup(th, op, _seed)
        _HIER[kind] = (th, op)
    return _HIER[kind]


def _seed(m):
    return m.init_field(lambda *c: sum(torch.sin(3 * x) for x in c))


def test_level_transfer_tables_match_jax():
    """JAX's builder on the same level maps (the port's maps equal JAX's:
    `tests/test_torch_multigrid.py::test_hierarchy_tables_match_jax`)."""
    from disco4est_tpu.parallel import mg as JMG
    from disco4est_tpu.parallel.repartition import PaddedLayout as JL

    th, _ = hierarchies("hanging")
    for n in (2, 4, 8):
        lays = [R.PaddedLayout.build(_weights(m), n) for m in th.meshes]
        jlays = [JL.build(_weights(m), n) for m in th.meshes]
        for i, tmap in enumerate(th.maps):
            t = PMG.build_level_transfer(tmap, lays[i], lays[i + 1], n)
            j = JMG.build_level_transfer(tmap, jlays[i], jlays[i + 1], n)
            for f in ("Bf", "Bc", "Hr", "Hp", "Kc", "D"):
                assert getattr(t, f) == getattr(j, f), f
            for f in ("bits", "copy", "r_send", "r_recv", "child_rows",
                      "p_send", "p_recv", "parent_rows"):
                np.testing.assert_array_equal(getattr(t, f),
                                              np.asarray(getattr(j, f)), f)


@pytest.mark.parametrize("kind", ["hanging", "hp"])
def test_sharded_transfers_bounds_and_vcycle_match_global(kind):
    from disco4est_tpu_torch.solvers import multigrid as tmg

    th, op = hierarchies(kind)
    deg, dim = th.meshes[0].deg, 3
    hp = th.hp
    b = torch.as_tensor(_field(th.meshes[0], 1, own=hp))
    x_ref = tmg.v_cycle(th, op, b, torch.zeros_like(b))
    fine = [torch.as_tensor(_field(m, 20 + i))
            for i, m in enumerate(th.meshes[:-1])]
    coarse = [torch.as_tensor(_field(m, 40 + i))
              for i, m in enumerate(th.meshes[1:])]
    for n in (1, 4):
        def rank(comm):
            sh = PMG.build_sharded_hierarchy(th, comm)
            bounds = PMG.mg_setup_sharded(sh, _seed)
            sh.bounds = th.bounds  # the same intervals for the V-cycle diff
            loc = lambda v, lev: shard_field(  # noqa: E731
                R.migrate_field(v, sh.layouts[lev]), comm.rank, comm.size)
            x = PMG.v_cycle_sharded(sh, loc(b, 0), torch.zeros_like(loc(b, 0)))
            rc = [PMG.restrict_sharded(t, loc(fine[i], i), deg, dim, comm)
                  for i, t in enumerate(sh.transfers)]
            ef = [PMG.prolong_sharded(t, loc(coarse[i], i + 1), deg, dim,
                                      comm)
                  for i, t in enumerate(sh.transfers)]
            return sh.layouts, bounds, x, rc, ef

        out = run_thread_ranks(n, rank)
        lays, bounds = out[0][0], out[0][1]
        g = lambda k, lev, i=None: R.unmigrate_field(  # noqa: E731
            torch.cat([o[k] if i is None else o[k][i] for o in out]),
            lays[lev], th.meshes[lev].n_elements).numpy()
        assert _rel(g(2, 0), x_ref.numpy()) <= 1e-10, n
        for i, lm in enumerate(th.maps):
            nc = th.meshes[i + 1].n_elements
            assert _rel(g(3, i + 1, i), tmg.restrict(
                lm, fine[i], deg, dim, nc).numpy()) <= 1e-13
            assert _rel(g(4, i, i), tmg.prolong(
                lm, coarse[i], deg, dim).numpy()) <= 1e-13
        for (a, b_), (c, d) in zip(bounds, th.bounds):
            assert abs(b_ - d) <= 1e-12 * d and abs(a - c) <= 1e-12 * c


def test_sharded_vcycle_refuses_schwarz_smoothers():
    """ROADMAP C2: the JAX module runs Chebyshev for them; the port
    raises."""
    import dataclasses

    th, _ = hierarchies("hanging")
    for sm in ("schwarz", "schwarz_overlap"):
        bad = dataclasses.replace(th.params, smoother=sm)
        h = type(th)(th.meshes, th.maps, bad, hp=th.hp)
        with pytest.raises(NotImplementedError, match="C2"):
            run_thread_ranks(1, lambda c: PMG.build_sharded_hierarchy(h, c))


# ---------------------------------------------------------------------------
# migration and the rank-count invariance of an AMR epoch
# ---------------------------------------------------------------------------


def test_migrate_roundtrip_and_fused_amr_transfer():
    """`tests/test_distributed_amr.py:test_migrate_roundtrip_and_amr_
    transfer`, and the fused transfer against JAX's."""
    import jax.numpy as jnp

    from disco4est_tpu.amr.amr import refine_and_balance as jrefine
    from disco4est_tpu.mesh.tree import Forest as JF
    from disco4est_tpu.parallel import repartition as JR
    from disco4est_tpu_torch.amr.amr import refine_and_balance, transfer_field
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.mesh.tree import Forest

    geom = BrickGeometry(dim=3)
    forest = Forest.uniform(geom.conn, 1)
    rng = np.random.default_rng(1)
    u_np = rng.standard_normal((8, 3, 3, 3))
    u = torch.as_tensor(u_np)
    layout = R.PaddedLayout.build(rng.uniform(1, 3, size=8), 4)
    assert torch.equal(R.unmigrate_field(R.migrate_field(u, layout),
                                         layout, 8), u)
    for flags in ([0], [0, 7], [3, 4, 5]):
        fl = np.zeros(8, bool)
        fl[flags] = True
        new = refine_and_balance(forest, fl)
        layout2 = R.PaddedLayout.build(np.ones(new.n_elements), 4)
        fused = R.migrate_after_amr(u, forest, new, 2, layout2)
        host = R.migrate_field(transfer_field(forest, new, u, 2), layout2)
        assert _rel(fused.numpy(), host.numpy()) <= 1e-14
        jf = JF.uniform(geom.conn, 1)
        jfused = JR.migrate_after_amr(
            jnp.asarray(u_np), jf, jrefine(jf, fl), 2,
            JR.PaddedLayout.build(np.ones(new.n_elements), 4))
        assert _rel(fused.numpy(), jfused) <= 1e-14


def _amr_epoch(n):
    """`tests/test_distributed_amr.py:_amr_epoch` on n ranks: a halo CG
    step on the level-1 brick, the estimate and smooth_pred marks of its
    iterate, refine + balance, the fused migration into the new layout and
    a halo CG step there.  Returns the marks and the last iterate in
    global order."""
    from disco4est_tpu_torch.amr.amr import refine_and_balance
    from disco4est_tpu_torch.amr.smooth_pred import (
        SmoothPredParams,
        SmoothPredState,
        smooth_pred_mark,
    )
    from disco4est_tpu_torch.estimators.bi import estimate_bi
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    deg, a = 2, 20.0
    geom = BrickGeometry(dim=3)
    r2f = lambda x, y, z: (x - 0.3) ** 2 + (y - 0.2) ** 2 + (z - 0.7) ** 2  # noqa
    u_fcn = lambda x, y, z: torch.exp(-a * r2f(x, y, z))  # noqa: E731
    f_fcn = lambda x, y, z: u_fcn(x, y, z) * (6 * a - 4 * a * a  # noqa
                                              * r2f(x, y, z))

    def rhs_of(mesh):
        return build_rhs_with_strong_bc(mesh, mesh.init_field(f_fcn),
                                        mesh.boundary_values(u_fcn))

    def rank(comm):
        def epoch(mesh, x_l=None):
            lay = R.PaddedLayout.build(_weights(mesh), comm.size)
            mp = R.pad_mesh_to_layout(mesh, lay)
            m_l = shard_mesh_data(mp, comm.rank, comm.size)
            h_l = H.build_halo_program(mp, comm.size).local(comm.rank)
            b_l = shard_field(R.migrate_field(rhs_of(mesh), lay), comm.rank,
                              comm.size)
            A = lambda v: H.apply_sipg_halo(m_l, h_l, v, comm)  # noqa: E731
            x_l = torch.zeros_like(b_l) if x_l is None else x_l
            r = b_l - A(x_l)
            Ar = A(r)
            x_l = x_l + comm.dot(r, r) / comm.dot(r, Ar) * r
            return lay, R.unmigrate_field(comm.all_gather_rows(x_l), lay,
                                          mesh.n_elements)

        forest = Forest.uniform(geom.conn, 1)
        mesh = build_mesh(geom, forest, deg=deg, device="cpu")
        _, u = epoch(mesh)
        F = apply_sipg(mesh, u) - rhs_of(mesh)
        eta2 = comm.broadcast(estimate_bi(mesh, u, F,
                                          mesh.boundary_values(u_fcn)).numpy())
        sp = SmoothPredParams(percentile=25.0, max_degree=deg)
        deg_e = np.full(mesh.n_elements, deg, np.int32)
        log, _ = smooth_pred_mark(eta2, deg_e, SmoothPredState.fresh(
            mesh.n_elements, sp), sp, dim=3)
        new = refine_and_balance(forest, log < 0)
        mesh2 = build_mesh(geom, new, deg=deg, device="cpu")
        lay2 = R.PaddedLayout.build(_weights(mesh2), comm.size)
        u2 = R.migrate_after_amr(u, forest, new, deg, lay2)
        _, x2 = epoch(mesh2, shard_field(u2, comm.rank, comm.size))
        return log, x2

    return run_thread_ranks(n, rank)


def test_amr_epoch_rank_count_invariance():
    """1 rank against 8 through a whole adaptive epoch: the reference's
    `d4est_test_mpi.sh` contract on an adapted mesh; every rank ends with
    the same marks and the same gathered iterate."""
    one = _amr_epoch(1)[0]
    eight = _amr_epoch(8)
    for log, x in eight:
        assert np.array_equal(log, one[0]) and (log < 0).any()
        assert torch.equal(x, eight[0][1])
    assert float((eight[0][1] - one[1]).abs().max()) < 1e-12


def test_c17_witness_general_form_cg_matches_the_distributed_cg():
    """ROADMAP C17's witness at a small size (sinx, deg 2, level 2): the
    driver's distributed f64 CG on two thread ranks (the halo program's
    quadrature-point face terms) lands on the L2 error of a one-process
    f64 CG through the general form (`apply_sipg(..., volume_mode=
    "dense")`, off the GEMM-form fast path) to 1e-10 relative, the bound
    `chip_smoke.py` phase 15 holds at level 5; the GEMM-form CG, the
    operator's other f64 form, is within `DIST_FORM_REL` (1e-5) of both."""
    from disco4est_tpu_torch import driver
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.io.norms import norm_L2
    from disco4est_tpu_torch.laplacian.sipg import (
        apply_sipg,
        build_rhs_with_strong_bc,
    )
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest
    from disco4est_tpu_torch.problems.poisson import SinxProblem
    from disco4est_tpu_torch.solvers.cg import cg_solve

    geom = BrickGeometry(dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 2), deg=2,
                      device="cpu")
    rhs = build_rhs_with_strong_bc(
        mesh, mesh.init_field(SinxProblem.rhs),
        mesh.boundary_values(SinxProblem.boundary))
    x0 = torch.zeros_like(rhs)
    kw = dict(x0=x0, atol=5e-15, rtol=1e-20, max_iter=100000)
    witness = cg_solve(lambda v: apply_sipg(mesh, v, volume_mode="dense"),
                       rhs, **kw)
    gemm = cg_solve(lambda v: apply_sipg(mesh, v), rhs, **kw)

    def rank(comm):
        ep = driver.ParallelContext(comm).distribute(mesh)
        return driver._solve_dist(ep, rhs, x0, hp=False, use_mixed=False,
                                  ksp="cg", mixed_opts={})

    (info, x), (_, x1) = run_thread_ranks(2, rank)
    assert info.path == "cg-halo" and torch.equal(x, x1)
    u_a = mesh.init_field(SinxProblem.analytic)
    l2 = {k: float(norm_L2(mesh, v - u_a))
          for k, v in (("dist", x), ("witness", witness.x),
                       ("gemm", gemm.x))}
    assert abs(l2["dist"] - l2["witness"]) <= 1e-10 * l2["witness"], l2
    assert abs(l2["gemm"] - l2["witness"]) <= 1e-5 * l2["witness"], l2
