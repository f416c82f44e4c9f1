"""The structured CUDA kernel against its plain PyTorch version, on a card.

Needs a CUDA device and `nvcc`; every test skips without a device (the
kernel has no CPU mode).  This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernel.py --noconftest -q

Tolerance: 5e-6 relative (max |Δ| / max |ref|), the f32 bound of
`tests/test_structured.py`, against the plain version and the f64 apply.
"""

import numpy as np
import pytest
import torch

from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.laplacian import structured as S
from disco4est_tpu_torch.laplacian.fast import _apply_orth
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest

REL_TOL = 5e-6
CASES = [(1, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 1.0, 1.0)),
         (3, 2, (1.0, 1.0, 1.0)), (5, 2, (1.0, 1.0, 1.0)),
         (7, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 2.0, 4.0)),
         (4, 2, (2.0, 1.0, 1.0)), (3, 5, (1.0, 1.0, 1.0))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _brick(deg, level, x1, device):
    geom = BrickGeometry(x1=x1, dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                      device=device)
    return mesh, S.build_structured(mesh)


def _rel(a, ref):
    return float((a.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("deg,level,x1", CASES)
def test_kernel_matches_plain_and_f64(cuda_device, deg, level, x1):
    mesh, sb = _brick(deg, level, x1, cuda_device)
    E = mesh.n_elements
    u = torch.as_tensor(
        np.random.default_rng(deg).standard_normal((E, sb.nv)),
        dtype=torch.float32, device=cuda_device,
    )
    before = S.KERNEL_LAUNCHES
    out = S.apply_structured(sb, u)
    torch.cuda.synchronize()
    assert S.KERNEL_LAUNCHES == before + 1
    assert _rel(out, S.apply_structured_plain(sb, u)) <= REL_TOL
    ref64 = S.to_lex(sb, _apply_orth(
        mesh, S.from_lex(sb, u.double()).reshape((E,) + (deg + 1,) * 3)
    ).reshape(E, -1))
    assert _rel(out, ref64) <= REL_TOL


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_inputs(cuda_device):
    _, sb = _brick(2, 1, (1.0, 1.0, 1.0), cuda_device)
    u = torch.zeros((sb.n_elements, sb.nv), device=cuda_device)
    tr = S.compute_traces_lex(sb, u)
    with pytest.raises(ValueError, match="float32"):
        S.lex_apply_cuda(sb, u.double(), tr)
    with pytest.raises(ValueError, match="contiguous"):
        S.lex_apply_cuda(sb, u, tr.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        S.lex_apply_cuda(sb, u[:-1].contiguous(), tr)
