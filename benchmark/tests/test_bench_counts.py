"""The frozen counts against hand-worked values, and the plain reference
against solutions it must reproduce exactly."""

import math

import pytest
import torch

from benchmark import counts
from benchmark.reference.brick import Brick, lobatto, morton_order


def test_counts_deg3_level5():
    # per element, nl = nq = 4: derivatives 3*2*4*4*16 = 1536 (twice),
    # interpolations 3*2*4*4*16 = 1536 (3 + 3 of them), pointwise
    # (9 + 3)*64*2 = 1536: 9 * 1536 = 13824; face interpolations
    # 6*2*2*4*4*4*4 = 6144; face terms 6*16*2*12 = 2304
    assert counts.apply_flops(32768, 3, 4, 4) == 32768 * 22272
    # (2*64 + 9 + 6*5 + 6) * 4 bytes = 692 bytes an element
    assert counts.apply_bytes(32768, 3, 4) == 32768 * 692 == 22675456
    t, bound = counts.least_seconds(32768, 3, 4, 4)
    assert bound == "bytes"
    assert t == pytest.approx(22675456 / 3.35e12, rel=1e-15)


def test_counts_deg7_level4():
    # nl = nq = 8: derivatives 3*2*8*8*64 = 24576 (twice), interpolations
    # 24576 (six), pointwise 12*512*2 = 12288: 8*24576 + 12288 = 208896;
    # faces 6*2*2*8*8*8*4 = 49152 and 6*64*2*12 = 9216
    assert counts.apply_flops(4096, 3, 8, 8) == 4096 * 267264
    assert counts.apply_bytes(4096, 3, 8) == 4096 * 4276 == 17514496
    t, bound = counts.least_seconds(4096, 3, 8, 8)
    assert bound == "bytes"
    assert t == pytest.approx(17514496 / 3.35e12, rel=1e-15)
    # against the dense TF32 peak the operations need less time
    assert 4096 * 267264 / 495e12 < t


def test_lobatto_rules():
    for n in range(2, 9):
        x, w = lobatto(n)
        assert x[0] == -1.0 and x[-1] == 1.0
        assert sum(w) == pytest.approx(2.0, abs=1e-15)
        # exact for polynomials of degree 2n - 3
        for k in range(2 * n - 2):
            exact = 0.0 if k % 2 else 2.0 / (k + 1)
            assert float((w * x**k).sum()) == pytest.approx(exact, abs=1e-14)


def test_morton_order():
    key = morton_order(1)  # [z, y, x]
    assert key[0, 0, 1] == 1 and key[0, 1, 0] == 2 and key[1, 0, 0] == 4
    assert sorted(morton_order(3).reshape(-1)) == list(range(512))


@pytest.mark.parametrize("level,deg", [(1, 2), (2, 3), (1, 4)])
def test_reference_reproduces_polynomial(level, deg):
    """SIPG is consistent: a solution in the discrete space with its own
    Dirichlet data is reproduced to rounding."""
    u = lambda x, y, z: x * x * y - 2.0 * z**2 + x * z + 1.0
    f = lambda x, y, z: -2.0 * y + 4.0 + 0.0 * x
    brick = Brick.build(level, deg)
    z, y, x = brick.node_coords()
    U = u(x, y, z)
    b = brick.rhs(f, u)
    assert float(torch.linalg.vector_norm(b - brick.apply(U))
                 / torch.linalg.vector_norm(b)) < 1e-13
    V = brick.solver()(b)
    assert float((V - U).abs().max()) < 1e-12
    # the layouts round-trip
    assert torch.equal(brick.to_grid(brick.from_grid(U)), U)


def test_reference_converges_on_sinx():
    """The discrete sinx solution's L2 error falls as h^(p+1)."""
    from benchmark.reference.problems import Sinx

    p = Sinx((0.4, 1.3, 2.2))
    errs = []
    for level in (1, 2):
        brick = Brick.build(level, 2)
        _, l2 = p.solve(brick)
        errs.append(l2)
    assert math.log2(errs[0] / errs[1]) > 2.5
