"""Point interpolation probe.

Port of `disco4est_tpu/mesh/probe.py` (role of the reference's
`d4est_mesh_interpolate_at_tree_coord`, `Mesh/d4est_mesh.h:208`, which
the TwoPunctures drivers' point monitors use): evaluate a nodal DG field
at a physical point by locating the element that holds it, inverting the
element's geometry map, and evaluating the Lagrange tensor basis there.

Host work in f64 torch on the CPU.  The JAX version inverts one candidate
element after another with an eager autodiff Jacobian; here every
candidate runs the same Newton iteration at once, each stopping on its own
test, and the Jacobian is the geometry's `dx` (closed form on the brick,
`torch.func.jacfwd` on the spheres).  The element picked is the one the
sequential scan would pick: the first candidate, in element order, whose
inversion lands in [0, 1]^dim.
"""

from __future__ import annotations

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import MeshData
from disco4est_tpu_torch.mesh.tree import ROOT
from disco4est_tpu_torch.ops.operators import DB

_NEWTON_STEPS = 60


def _invert(mesh: MeshData, elems, xyz, clip: bool):
    """Newton inversion of the geometry maps of `elems` at `xyz`, from
    r = ½ in each element: (r [C, dim], converged [C] bool).  Each
    candidate stops when its residual passes the JAX test, or when its
    Jacobian is singular (not converged); `clip` keeps r in [−½, 3/2]."""
    dim = mesh.dim
    forest = mesh.forest
    kw = dict(dtype=torch.float64)
    tree = torch.as_tensor(forest.tree[elems].astype(np.int64))
    a = torch.as_tensor(forest.anchor[elems], **kw).reshape(-1, dim) / ROOT
    h = torch.as_tensor(2.0 ** -forest.level[elems].astype(np.float64), **kw)
    target = torch.as_tensor(np.asarray(xyz, np.float64), **kw)
    tol = 1e-12 * max(1.0, float(np.abs(np.asarray(xyz)).max()))
    C = len(elems)
    r = torch.full((C, dim), 0.5, **kw)
    active = torch.ones(C, dtype=torch.bool)
    done = torch.zeros(C, dtype=torch.bool)
    for _ in range(_NEWTON_STEPS):
        idx = torch.nonzero(active).reshape(-1)
        if idx.numel() == 0:
            break
        rst = a[idx] + h[idx, None] * r[idx]
        F = mesh.geom.x(tree[idx], rst) - target
        ok = F.abs().amax(-1) < tol
        done[idx[ok]] = True
        active[idx[ok]] = False
        idx, rst, F = idx[~ok], rst[~ok], F[~ok]
        if idx.numel() == 0:
            break
        J = mesh.geom.dx(tree[idx], rst) * h[idx, None, None]
        dr, info = torch.linalg.solve_ex(J, F[..., None])
        singular = info != 0
        active[idx[singular]] = False  # the scan gives this one up
        idx, dr = idx[~singular], dr[~singular, :, 0]
        r_new = r[idx] - dr
        r[idx] = r_new.clamp(-0.5, 1.5) if clip else r_new
    return r, done


def locate_point(mesh: MeshData, xyz, tol: float = 1e-10):
    """(element, local coords r in [0,1]^dim) holding `xyz`: candidates by
    their nodal bounding box inflated by 30 % (curved elements bulge past
    the nodal hull), then the inversion; the first candidate whose r lies
    in [0,1]^dim within `tol`, else the nearest one within 1e-6."""
    xyz = np.asarray(xyz, np.float64)
    dim, E = mesh.dim, mesh.n_elements
    nodes = mesh.xyz_lobatto.detach().cpu().numpy().reshape(E, dim, -1)
    lo = nodes.min(-1) - 1e-9
    hi = nodes.max(-1) + 1e-9
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    cand = np.nonzero(
        np.all((xyz >= mid - 1.3 * half) & (xyz <= mid + 1.3 * half), axis=1)
    )[0]
    if cand.size:
        r, done = _invert(mesh, cand, xyz, clip=True)
        r, done = r.numpy(), done.numpy()
        inside = done & np.all((r >= -tol) & (r <= 1 + tol), axis=1)
        if inside.any():
            k = int(np.argmax(inside))
            return int(cand[k]), np.clip(r[k], 0.0, 1.0)
        dist = (np.maximum(r - 1, 0).max(1) + np.maximum(-r, 0).max(1))
        dist = np.where(done, dist, np.inf)
        k = int(np.argmin(dist))  # first of the nearest, as the scan
        if dist[k] < 1e-6:
            return int(cand[k]), np.clip(r[k], 0.0, 1.0)
    raise ValueError(f"point {xyz} not found in mesh")


def _lagrange(nodes, x):
    n = len(nodes)
    vals = np.empty(n)
    for i in range(n):
        p = 1.0
        for j in range(n):
            if j != i:
                p *= (x - nodes[j]) / (nodes[i] - nodes[j])
        vals[i] = p
    return vals


def interpolate_at_point(mesh: MeshData, u, xyz, element: int | None = None):
    """(u at the physical point `xyz`, the element it was read from).
    `u`: nodal field [E, nl...].  Pass `element` to read it from that
    element's side (DG fields jump across faces)."""
    if element is None:
        e, r = locate_point(mesh, xyz)
    else:
        e = int(element)
        r, _ = _invert(mesh, np.array([e]), xyz, clip=False)
        r = r.numpy()[0]
    # Lagrange basis at the local coords ([0,1] -> [-1,1])
    xi = 2.0 * np.asarray(r) - 1.0
    nodes = np.asarray(DB.ops(mesh.deg).lobatto_nodes)
    basis = [_lagrange(nodes, xi[d]) for d in range(mesh.dim)]
    w = basis[mesh.dim - 1]
    for d in range(mesh.dim - 2, -1, -1):
        w = np.kron(w, basis[d])  # x fastest
    ue = u.detach().reshape(mesh.n_elements, -1)[e].cpu().numpy()
    return float(ue @ w), e
