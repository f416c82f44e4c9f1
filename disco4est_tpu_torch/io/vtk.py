"""VTK (.vtu) output of DG fields.

Port of `disco4est_tpu/io/vtk.py` (role of the reference's `IO/d4est_vtk.c`
and `p4est_vtk_ext.c`): the mesh as per-element blocks of deg^dim
sub-cells (VTK_PIXEL in 2D, VTK_VOXEL in 3D) with nodal corner values, the
"dg grid" output type, plus per-cell fields (tree and level by default).
A host writer of ASCII XML VTU, readable by ParaView and VisIt; its text
equals the JAX writer's for the same mesh and fields.  Device tensors are
copied to the host once each; the sub-cell connectivity is built for all
elements at once, and rows are formatted in blocks rather than one
`np.savetxt` call per row.
"""

from __future__ import annotations

import numpy as np

from disco4est_tpu_torch.io import to_host
from disco4est_tpu_torch.mesh.builder import MeshData, require_full

_BLOCK = 1 << 16  # rows formatted per string operation


def _write_rows(f, arr: np.ndarray, fmt: str):
    """The text `np.savetxt(f, arr, fmt=fmt)` writes for a 2D array: each
    row as `fmt` per column, joined by spaces, one row per line."""
    rows, cols = arr.shape
    line = " ".join([fmt] * cols) + "\n"
    for s in range(0, rows, _BLOCK):
        block = arr[s:s + _BLOCK]
        f.write((line * block.shape[0]) % tuple(block.reshape(-1).tolist()))


def _subcell_corners(nl: int, dim: int) -> np.ndarray:
    """[sub^dim, 2^dim] local node index of every sub-cell's corners:
    sub-cells x-fastest, corners x-fastest (VTK_PIXEL / VTK_VOXEL order)."""
    sub = nl - 1
    idx = np.arange(nl**dim).reshape((nl,) * dim)  # axes (z,) y, x
    cells = np.stack(np.meshgrid(*([np.arange(sub)] * dim), indexing="ij"),
                     axis=-1).reshape(-1, dim)  # slowest axis first
    offs = np.stack(np.meshgrid(*([np.arange(2)] * dim), indexing="ij"),
                    axis=-1).reshape(-1, dim)
    pos = cells[:, None, :] + offs[None, :, :]  # [cells, corners, dim]
    return idx[tuple(pos[..., d] for d in range(dim))]


def write_vtu(
    path: str,
    mesh: MeshData,
    point_fields: dict | None = None,
    cell_fields: dict | None = None,
):
    """point_fields: name -> [E, nl...] nodal arrays or tensors;
    cell_fields: name -> [E] per-element arrays."""
    require_full(mesh, "write_vtu")
    dim = mesh.dim
    nl = mesh.nl
    E = mesh.n_elements
    xyz = to_host(mesh.xyz_lobatto)  # [E, dim, nl...]
    point_fields = {k: to_host(v).reshape(E, -1)
                    for k, v in (point_fields or {}).items()}
    cell_fields = dict(cell_fields or {})
    cell_fields.setdefault("tree", mesh.forest.tree)
    cell_fields.setdefault("level", mesh.forest.level)

    n_pts_per_el = nl**dim
    n_cells_per_el = (nl - 1)**dim
    corners = 1 << dim
    cell_type = 8 if dim == 2 else 11  # VTK_PIXEL / VTK_VOXEL

    pts = np.zeros((E * n_pts_per_el, 3))
    pts[:, :dim] = xyz.reshape(E, dim, -1).transpose(0, 2, 1).reshape(-1, dim)
    conn = (_subcell_corners(nl, dim)[None]
            + (np.arange(E) * n_pts_per_el)[:, None, None]).reshape(-1,
                                                                    corners)

    n_points = E * n_pts_per_el
    n_cells = E * n_cells_per_el
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{n_points}" '
                f'NumberOfCells="{n_cells}">\n')
        f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        _write_rows(f, pts, "%.12g")
        f.write("</DataArray>\n</Points>\n<Cells>\n")
        f.write('<DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n')
        _write_rows(f, conn, "%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="Int64" Name="offsets" format="ascii">\n')
        _write_rows(f, (np.arange(1, n_cells + 1) * corners)[:, None], "%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write(f"{cell_type}\n" * n_cells)
        f.write("</DataArray>\n</Cells>\n")
        if point_fields:
            f.write("<PointData>\n")
            for name, arr in point_fields.items():
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        'format="ascii">\n')
                _write_rows(f, arr.reshape(-1, 1), "%.12g")
                f.write("</DataArray>\n")
            f.write("</PointData>\n")
        if cell_fields:
            f.write("<CellData>\n")
            for name, arr in cell_fields.items():
                rep = np.repeat(np.asarray(to_host(arr), np.float64),
                                n_cells_per_el)
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        'format="ascii">\n')
                _write_rows(f, rep.reshape(-1, 1), "%.12g")
                f.write("</DataArray>\n")
            f.write("</CellData>\n")
        f.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
