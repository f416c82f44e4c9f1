"""The V-cycle replayed as a CUDA graph (`solvers/multigrid.py`
`MGPreconditioner`), on the CPU with a stand-in graph and, where a card
is present, on the card.

- `graph_eligible` for every smoother and bottom plugin, hp flag and
  device;
- the call sequence eager → capture → launches, the capture made by a
  stand-in graph that records the body's aten calls and runs them again
  in order on each launch, each result written into the tensor the
  recording made (a CUDA graph's fixed addresses): every call equals an
  eager `v_cycle` bit for bit, and the tracer counts each call as one
  cycle (`mg.vcycles`, `mg.applies.*`, one `d4est.mg.vcycle` span) with
  `mg.graph.captures` / `mg.graph.replays`;
- a capture that raises: eager cycles for the rest of the epoch and
  `mg.graph.fallbacks`;
- a `run_poisson` multigrid epoch through the stand-in graph: the same
  FCG steps and answer as the eager driver and as FCG on the plain
  `v_cycle`, and after the solve neither the apply nor
  `DriverResult.precond` holds the graph or a static buffer;
- on the CPU `mg_preconditioner` equals `v_cycle` bit for bit;
- the tracer's `tally` and the benchmark's `vcycle_graph_share` reader;
- on a card (marker `gpu`): a replayed level-3 cycle equals the eager
  one bit for bit, and the driver's FCG-MG solve equals the one with
  the graph forced off.
"""

import functools
import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from disco4est_tpu_torch import driver
from disco4est_tpu_torch.laplacian.sipg import apply_sipg
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.problems.poisson import SinxProblem
from disco4est_tpu_torch.solvers import multigrid as MG
from disco4est_tpu_torch.solvers.fcg import fcg_solve
from disco4est_tpu_torch.util import trace
from disco4est_tpu_torch.util.config import Options

from torch_threads import torch_worker_threads  # noqa: F401

OPTIONS = """
[geometry]
name = brick
[problem]
name = sinx
[initial_mesh]
min_level = {level}
region0_deg = 3
[amr]
scheme = uniform_h
num_of_amr_steps = {steps}
[d4est_solver_krylov_petsc]
ksp_type = fcg
pc_type = multigrid
"""


class StandInGraph:
    """A CUDA graph's replay on the CPU: the aten calls recorded while
    the body ran once, run again in order by `replay`.  A result that is
    not a view or an in-place result of an argument is copied into the
    tensor the recording returned, so later calls read it there, as a
    graph's kernels read fixed addresses."""

    def __init__(self):
        self.ops, self.replays = [], 0

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            inputs = {t.untyped_storage().data_ptr()
                      for t in tree_flatten((args, kwargs))[0]
                      if isinstance(t, torch.Tensor)}
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if (isinstance(o, torch.Tensor)
                        and o.untyped_storage().data_ptr() not in inputs):
                    o.copy_(n)


class _Recording(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out


def stand_in_capture(made):
    """`MG._capture` on the CPU: the body runs once under the recording
    (a CUDA capture runs nothing; the first launch follows either way);
    each graph made is appended to `made`."""

    def capture(fn):
        graph = StandInGraph()
        with _Recording(graph):
            out = fn()
        made.append(graph)
        return graph, out

    return capture


def _graphed(monkeypatch, made):
    monkeypatch.setattr(MG, "graph_eligible", lambda hier, device: True)
    monkeypatch.setattr(MG, "_capture", stand_in_capture(made))


_HIER = {}


def hierarchy(level, deg=3):
    """(mesh, hierarchy set up by `mg_setup`) of the unit brick."""
    if (level, deg) not in _HIER:
        geom = driver.geometry_from_options(Options.load(OPTIONS.format(
            level=level, steps=0)))
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device="cpu")
        h = MG.build_hierarchy(mesh)
        MG.mg_setup(h, apply_sipg, driver._sin3_seed)
        _HIER[level, deg] = mesh, h
    return _HIER[level, deg]


def residuals(mesh, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((mesh.n_elements,) + (mesh.nl,) * 3,
                        dtype=torch.float64, generator=g) for _ in range(n)]


def traced(fn):
    """Run `fn()` as a traced driver run: (fn's value, the record)."""

    @trace.traced_run()
    def run():
        return types.SimpleNamespace(value=fn())

    res = run()
    return res.value, res.trace


def _spans(record, name):
    return [s for s in record["spans"] if s["name"] == name]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("hp", [False, True])
@pytest.mark.parametrize("bottom", MG.BOTTOMS)
@pytest.mark.parametrize("smoother", MG.SMOOTHERS)
def test_graph_eligible_rule(smoother, bottom, hp, device):
    hier = types.SimpleNamespace(
        params=MG.MGParams(smoother=smoother, bottom=bottom), hp=hp)
    want = (device == "cuda" and not hp and smoother in ("cheby", "none")
            and bottom in ("cg", "cheby"))
    assert MG.graph_eligible(hier, device) == want
    assert MG.graph_eligible(hier, torch.device(device)) == want


def test_cpu_apply_equals_the_eager_vcycle():
    mesh, h = hierarchy(2)
    M = MG.mg_preconditioner(h, apply_sipg)
    for r in residuals(mesh, 3):
        assert torch.equal(M(r), MG.v_cycle(h, apply_sipg, r,
                                            torch.zeros_like(r)))
    assert M.graph is None and M.b is None


def test_eager_capture_then_launches(monkeypatch):
    mesh, h = hierarchy(2)
    rs = residuals(mesh, 5, seed=1)
    want, eager = traced(lambda: [MG.v_cycle(h, apply_sipg, r,
                                             torch.zeros_like(r))
                                  for r in rs])
    made = []
    _graphed(monkeypatch, made)
    M = MG.mg_preconditioner(h, apply_sipg)

    def calls():
        outs = []
        for k, r in enumerate(rs):
            outs.append(M(r))
            # the capture comes with the second call, not before
            assert len(made) == (0 if k == 0 else 1)
        return outs

    outs, record = traced(calls)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    # each call returns a tensor of its own, not the static output
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert all(o.data_ptr() != M.out.data_ptr() for o in outs)
    assert made[0].replays == 4  # the capture call's launch and three more
    c, ce = record["counters"], eager["counters"]
    for k in ("mg.vcycles", "mg.levels", "mg.applies.fine",
              "mg.applies.coarse"):
        assert c[k] == ce[k], k
    assert c["mg.vcycles"] == 5 and c["mg.applies.fine"] == 5 * 17
    assert c["mg.graph.captures"] == 1 and c["mg.graph.replays"] == 4
    assert "mg.graph.fallbacks" not in c
    assert len(_spans(record, "d4est.mg.vcycle")) == 5
    (cap,) = _spans(record, "d4est.mg.graph.capture")
    index = record["spans"].index(cap)
    inner = [s for s in record["spans"] if s["parent"] == index]
    assert [s["name"] for s in inner] == ["d4est.mg.vcycle"]


def test_capture_that_raises_falls_back_to_eager(monkeypatch):
    mesh, h = hierarchy(2)
    rs = residuals(mesh, 4, seed=2)
    tries = []

    def failing(fn):
        tries.append(fn)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(MG, "graph_eligible", lambda hier, device: True)
    monkeypatch.setattr(MG, "_capture", failing)
    M = MG.mg_preconditioner(h, apply_sipg)
    outs, record = traced(lambda: [M(r) for r in rs])
    for got, r in zip(outs, rs):
        assert torch.equal(got, MG.v_cycle(h, apply_sipg, r,
                                           torch.zeros_like(r)))
    assert len(tries) == 1 and M.graph is None and M.b is None
    c = record["counters"]
    assert c["mg.graph.fallbacks"] == 1 and c["mg.vcycles"] == 4
    assert "mg.graph.replays" not in c and "mg.graph.captures" not in c


def test_eager_keyword_never_captures(monkeypatch):
    mesh, h = hierarchy(2)
    made = []
    _graphed(monkeypatch, made)
    M = MG.mg_preconditioner(h, apply_sipg, eager=True)
    for r in residuals(mesh, 3, seed=3):
        M(r)
    assert made == [] and M.graph is None


def _run(level=2, steps=0):
    return driver.run_poisson(Options.load(OPTIONS.format(
        level=level, steps=steps)), SinxProblem, device="cpu")


@pytest.mark.parametrize("steps", [0, 1])
def test_driver_epoch_through_the_graph_releases_it(monkeypatch, steps):
    eager = _run(1, steps)
    made, applies = [], []

    def recorded(hier, A, **kw):
        applies.append(MG.mg_preconditioner(hier, A, **kw))
        return applies[-1]

    _graphed(monkeypatch, made)
    monkeypatch.setattr(driver, "mg_preconditioner", recorded)
    res = _run(1, steps)
    assert [s.path for s in res.solves] == ["fcg-mg"] * (steps + 1)
    assert ([s.iterations for s in res.solves]
            == [s.iterations for s in eager.solves])
    assert torch.equal(res.u, eager.u)
    assert len(made) == len(applies) == steps + 1
    assert all(g.replays == s.iterations for g, s in zip(made, res.solves))
    c = res.trace["counters"]
    assert c["mg.graph.captures"] == steps + 1
    assert c["mg.graph.replays"] == sum(s.iterations for s in res.solves)
    assert c["mg.vcycles"] == eager.trace["counters"]["mg.vcycles"]
    for M in applies:
        assert (M.graph, M.b, M.out, M.counts) == (None,) * 4
    assert isinstance(res.precond, MG.MGHierarchy)
    held = [v for v in vars(res.precond).values()
            if isinstance(v, (MG.MGPreconditioner, StandInGraph))]
    assert held == []


def test_driver_fcg_steps_equal_fcg_on_the_plain_vcycle():
    """The driver's FCG-MG epoch (`mg_preconditioner`) against
    `fcg_solve` with the V-cycle as a plain function, the apply before
    the graph: the same steps and answer, bit for bit."""
    res = _run(2)
    mesh = res.mesh
    h = res.precond
    rhs = driver.build_rhs_with_strong_bc(
        mesh, mesh.init_field(SinxProblem.rhs),
        mesh.boundary_values(SinxProblem.boundary))
    ref = fcg_solve(lambda v: apply_sipg(mesh, v), rhs,
                    x0=torch.zeros_like(rhs),
                    M=lambda r: MG.v_cycle(h, apply_sipg, r,
                                           torch.zeros_like(r)),
                    atol=5e-15, rtol=1e-20, max_iter=10000)
    assert res.solves[0].iterations == ref.iterations == 15
    assert torch.equal(res.u, ref.x)


def test_tally_keeps_counts_until_added():
    def body():
        with trace.tally() as t:
            trace.count("a", 2)
            trace.high("h", 5)
            trace.high("h", 3)
        t.add()
        t.add()
        trace.count("b")
        return t

    t, record = traced(body)
    assert t.counts == {"a": 2} and t.highs == {"h": 5}
    c = record["counters"]
    assert c["a"] == 4 and c["h"] == 5 and c["b"] == 1
    with trace.tally() as outside:  # outside a run too
        trace.count("a")
    assert outside.counts == {"a": 1}
    outside.add()  # and adding outside a run does nothing


def test_vcycle_graph_share_reader():
    from benchmark.metrics import vcycle_graph_share as V

    graphed = {"mg.vcycles": 17, "mg.graph.replays": 16,
               "mg.graph.captures": 1}
    assert V.share({"counters": graphed}) == pytest.approx(16 / 17)
    failed = {"mg.vcycles": 17, "mg.graph.fallbacks": 1}
    assert V.share({"counters": failed}) == 0.0
    assert V.share({"counters": {"mg.vcycles": 17}}) is None
    assert V.share({"counters": {"mg.graph.replays": 3}}) is None
    assert V._counter("mg.graph.fallbacks")({"counters": graphed}) == 0
    assert V._counter("mg.graph.fallbacks")(
        {"counters": {"mg.vcycles": 3}}) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_replayed_cycle_equals_the_eager_one_on_the_card(cuda_device):
    geom = driver.geometry_from_options(Options.load(OPTIONS.format(
        level=3, steps=0)))
    mesh = build_mesh(geom, Forest.uniform(geom.conn, 3), deg=3,
                      device=cuda_device)
    h = MG.build_hierarchy(mesh)
    MG.mg_setup(h, apply_sipg, driver._sin3_seed)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rs = [torch.randn((mesh.n_elements, 4, 4, 4), dtype=torch.float64,
                      device=cuda_device, generator=gen) for _ in range(4)]
    M = MG.mg_preconditioner(h, apply_sipg)
    outs, record = traced(lambda: [M(r) for r in rs])
    assert M.graph is not None
    for got, r in zip(outs, rs):
        assert torch.equal(got, MG.v_cycle(h, apply_sipg, r,
                                           torch.zeros_like(r)))
    c = record["counters"]
    assert c["mg.graph.captures"] == 1 and c["mg.graph.replays"] == 3
    assert "mg.graph.fallbacks" not in c
    M.release()
    assert M.graph is None


@pytest.mark.gpu
def test_driver_solve_equals_the_graph_forced_off(cuda_device, monkeypatch):
    text = OPTIONS.format(level=3, steps=1)
    res = driver.run_poisson(Options.load(text), SinxProblem,
                             device=cuda_device)
    monkeypatch.setattr(driver, "mg_preconditioner", functools.partial(
        MG.mg_preconditioner, eager=True))
    off = driver.run_poisson(Options.load(text), SinxProblem,
                             device=cuda_device)
    assert ([s.iterations for s in res.solves]
            == [s.iterations for s in off.solves])
    assert torch.equal(res.u, off.u)
    assert res.trace["counters"]["mg.graph.captures"] == 2
    assert "mg.graph.captures" not in off.trace["counters"]


def test_vcycle_leaves_no_reference_cycle():
    """A V-cycle's closures hold no cycle: once the caller drops the
    answer, nothing of the hierarchy waits for the cyclic collector
    (which, run late, kept a finished run's meshes alive into the next
    run's mesh build)."""
    import gc

    mesh, h = hierarchy(2)
    r = residuals(mesh, 1, seed=6)[0]
    gc.collect()
    gc.disable()
    try:
        MG.v_cycle(h, apply_sipg, r, torch.zeros_like(r))
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage
                if isinstance(o, (torch.Tensor, MG.MGHierarchy))
                or type(o).__name__ == "function"
                and o.__qualname__.startswith("v_cycle.")]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
