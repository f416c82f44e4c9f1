"""Mass-weighted nonlinear terms: M·f(x,u) and its linearization.

Port of `disco4est_tpu/laplacian/nonlinear.py` (role of the reference's
`d4est_quadrature_apply_fofufofvlj` / `apply_fofufofvlilj`,
`Quadrature/d4est_quadrature.h:135-139`): integrate a pointwise function
of the solution against the test functions (the nonlinear term of a
Newton residual), and the frozen-u0 term of the Jacobian (e.g.
ConstantDensityStar's −2πρψ⁵ / −10πρψ⁴·v, TwoPunctures' ψ⁻⁷ / ψ⁻⁸ terms).

`fof(xyz, u_q)` and `dfof(xyz, u0_q)` are pointwise torch functions of the
coordinate tuple and the field at the volume quadrature points.

The frozen-u0 term of a Krylov iteration, `apply_mass_coeff`, has two
versions of one function:

- `mass_apply_cuda`: the hand-written kernel (`csrc/mass_apply.cu`, one
  pass over each element's v and coefficient), for CUDA tensors of one
  type (f32 or f64) on a mesh without a per-element radial rule, dim 2 or
  3, n = deg + 1 in 2-8 and nq = n to n + 2;
- `apply_mass_coeff_plain`: `vol_interp`, the product, `vol_interp`
  transposed, in plain torch ops; every other input takes it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from disco4est_tpu_torch.mesh.builder import MeshData, vol_interp, vol_weights
from disco4est_tpu_torch.ops import tensor
from disco4est_tpu_torch.util.cuda_build import check_operand, load_library

SOURCE = "mass_apply.cu"
# what `csrc/mass_apply.cu` is instantiated for
KERNEL_DTYPES = (torch.float32, torch.float64)
KERNEL_DIMS = (2, 3)
KERNEL_N = range(2, 9)  # n = deg + 1
KERNEL_NQ_EXTRA = range(3)  # nq - n

# Launch counter of the mass kernel: the wrapper adds one each time it
# launches the kernel, so a run can show that its Jacobian went through it.
KERNEL_LAUNCHES = 0


def _xyz_quad(mesh: MeshData, dtype):
    return tuple(mesh.xyz_quad[:, d].to(dtype) for d in range(mesh.dim))


def apply_mass_fof(mesh: MeshData, u, fof):
    """Vᵀ W J f(x_q, u_q): the nodal vector of ∫ f(x,u) φ_i dV."""
    dtype = u.dtype
    w = vol_weights(mesh, dtype)
    f_q = fof(_xyz_quad(mesh, dtype), vol_interp(mesh, u))
    return vol_interp(mesh, w * mesh.j_quad.to(dtype) * f_q, transpose=True)


def apply_mass_fof_lin(mesh: MeshData, u0, v, dfof):
    """Vᵀ W J f'(x_q, u0_q) ⊙ v_q: the frozen-u0 Jacobian term."""
    return apply_mass_coeff(mesh, fof_lin_coeff(mesh, u0, dfof, v.dtype), v)


def fof_lin_coeff(mesh: MeshData, u0, dfof, dtype=None):
    """W J f'(x_q, u0_q) at the volume quadrature points [E, nq...]: the
    frozen-u0 part of `apply_mass_fof_lin`, to evaluate once per Newton
    step rather than once per Krylov iteration (eager torch runs every
    pointwise operation of `dfof` as a launch; XLA fuses them)."""
    dtype = dtype or u0.dtype
    w = vol_weights(mesh, dtype)
    c_q = dfof(_xyz_quad(mesh, dtype), vol_interp(mesh, u0.to(dtype)))
    return w * mesh.j_quad.to(dtype) * c_q


def apply_mass_coeff(mesh: MeshData, coeff, v):
    """Vᵀ (coeff ⊙ V v), with coeff from `fof_lin_coeff`: the same
    products in the same order as `apply_mass_fof_lin`.  The kernel where
    it takes the inputs (the module's docstring), else the plain version."""
    if (v.device.type == "cuda" and coeff.dtype == v.dtype
            and mass_kernel_fits(mesh, v.dtype)):
        return mass_apply_cuda(mesh, _dense(coeff), _dense(v))
    return apply_mass_coeff_plain(mesh, coeff, v)


def _dense(t):
    """`t` itself where it is contiguous and 16-byte aligned, as the
    Krylov vectors are, else a fresh copy (the hp prolongation
    `laplacian/hp.py` `to_max` returns strided views)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def apply_mass_coeff_plain(mesh: MeshData, coeff, v):
    """`apply_mass_coeff` in plain torch ops."""
    return vol_interp(mesh, coeff * vol_interp(mesh, v), transpose=True)


def mass_kernel_fits(mesh: MeshData, dtype) -> bool:
    """Whether `csrc/mass_apply.cu` has an instance for this mesh and type:
    no per-element radial rule, and dim, n and nq in its range."""
    n = mesh.deg + 1
    return (mesh.rad_interp is None and dtype in KERNEL_DTYPES
            and mesh.dim in KERNEL_DIMS and n in KERNEL_N
            and mesh.deg_quad - mesh.deg in KERNEL_NQ_EXTRA)


def check_mass_operands(mesh: MeshData, coeff, v):
    """The mass kernel's operand check: v [E, n, ...] and coeff
    [E, nq, ...], contiguous, of one type the kernel takes, on v's device,
    on a mesh it has an instance for; raises ValueError otherwise.
    Returns (E, n, nq)."""
    dev, dtype = v.device, v.dtype
    if not mass_kernel_fits(mesh, dtype):
        raise ValueError(
            f"mass kernel: no instance for dim {mesh.dim}, deg {mesh.deg}, "
            f"deg_quad {mesh.deg_quad}, {dtype}"
            + (", radial rule" if mesh.rad_interp is not None else ""))
    E, n, nq = v.shape[0], mesh.deg + 1, mesh.deg_quad + 1
    check_operand("v", v, (E,) + (n,) * mesh.dim, dev, dtype)
    check_operand("coeff", coeff, (E,) + (nq,) * mesh.dim, dev, dtype)
    if E == 0:
        raise ValueError("mass kernel: no elements")
    return E, n, nq


@functools.lru_cache(maxsize=None)
def _load():
    lib = load_library(SOURCE)
    for fn in (lib.d4est_mass_apply_f32, lib.d4est_mass_apply_f64):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.d4est_mass_tile_elems.argtypes = [ctypes.c_int] * 4
    lib.d4est_mass_tile_elems.restype = ctypes.c_int
    return lib


def mass_tile_elems(dim, n, nq, dtype) -> int:
    """The elements one block of the mass kernel owns (-1: no instance)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _load().d4est_mass_tile_elems(itemsize, dim, n, nq)


@functools.lru_cache(maxsize=64)
def _interp_host(deg, deg_quad, quad, dtype):
    """The [nq, n] interpolation in host memory, in `dtype`: the kernel
    takes it as a launch parameter."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return np.ascontiguousarray(quad.interp(deg, deg_quad), dtype=np_dtype)


def mass_apply_cuda(mesh: MeshData, coeff, v):
    """`apply_mass_coeff` on the card: launches `csrc/mass_apply.cu`.
    Raises on anything the kernel does not take and on a failed launch."""
    global KERNEL_LAUNCHES
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"mass kernel needs CUDA tensors, got {dev}")
    E, n, nq = check_mass_operands(mesh, coeff, v)
    if v.data_ptr() % 16 or coeff.data_ptr() % 16:
        raise ValueError("mass kernel: v and coeff must be 16-byte aligned")
    V = _interp_host(mesh.deg, mesh.deg_quad, mesh.quad, v.dtype)
    lib = _load()
    fn = (lib.d4est_mass_apply_f32 if v.dtype == torch.float32
          else lib.d4est_mass_apply_f64)
    out = torch.empty_like(v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(v.data_ptr(), coeff.data_ptr(), out.data_ptr(),
                 V.ctypes.data, E, mesh.dim, n, nq, stream)
    if err != 0:
        raise RuntimeError(f"mass kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def assemble_fof_blocks(mesh: MeshData, u0, dfof, dtype=None):
    """Per-element dense blocks [E, n, n] of the frozen-u0 term
    Vᵀ diag(w·J·f'(x_q, u0_q)) V: the fine-level input of the multigrid
    matrix operator (`d4est_solver_multigrid_matrix_operator.h:1-21`).
    Like the JAX version it takes the shared Gauss rule (no per-element
    radial rule)."""
    dtype = dtype or u0.dtype
    dim = mesh.dim
    kw = dict(dtype=dtype, device=u0.device)
    V1 = np.asarray(mesh.quad.interp(mesh.deg, mesh.deg_quad))
    _, wq1 = mesh.quad.nodes_weights(mesh.deg_quad)
    w = tensor.tensor_weights([wq1] * dim, **kw)
    u0_q = tensor.apply_iso(torch.as_tensor(V1, **kw), u0.to(dtype), dim)
    c_q = dfof(_xyz_quad(mesh, dtype), u0_q)  # [E, nq...]
    E = c_q.shape[0]
    diag = (w * mesh.j_quad.to(dtype) * c_q).reshape(E, -1)  # [E, nq^d]
    # dense ⊗V, [nq^d, nl^d] in x-fastest flattening
    Vfull = np.array([[1.0]])
    for _ in range(dim):
        Vfull = np.kron(Vfull, V1)
    Vfull = torch.as_tensor(Vfull, **kw)
    # B = Vᵀ diag V per element, as one batched GEMM
    return Vfull.T @ (diag[:, :, None] * Vfull)
