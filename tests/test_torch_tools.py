"""The port's kernel-timing tools (`disco4est_tpu_torch/tools/`) on the CPU.

- B3's plain version (`exp_kernel_design.axis_apply_plain`) against the
  three-axis formula that the Pallas `kern` evaluates
  (`tools/exp_kernel_design.py:179-182`), written out here in jax.numpy
  because `kern` is a closure, to 1e-5 relative (f32 sums of 8 terms in
  another order).
- `time_fused.main` in its three modes and `exp_kernel_design.main` with
  `--device=cpu` at a small size: each prints its lines, and the errors
  they print are within the bounds of `tests/test_pallas_sipg.py`.
- `profile_solve.main` on the CPU at a small size (no device intervals
  there, and it says so), and the source edits of `ablate_sipg`, which
  must keep matching the tile code they cut.

The kernels themselves are tested on the card by `test_torch_kernel.py`.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disco4est_tpu_torch.tools import (
    ablate_sipg,
    compare_sipg,
    profile_solve,
    time_fused,
)
from disco4est_tpu_torch.tools import exp_kernel_design as X

from torch_threads import torch_worker_threads  # noqa: F401

AXIS_TOL = 1e-5
F32_TOL = 5e-6


def _jax_kern(u, m):
    v = u
    for ax in (1, 2, 3):
        v = jnp.moveaxis(jnp.moveaxis(v, ax, -1) @ m, -1, ax)
    return v


@pytest.mark.parametrize("E", [1, 7, 64])
def test_axis_plain_matches_jax_formula(E):
    rng = np.random.default_rng(E)
    u = rng.standard_normal((E, 8, 8, 8)).astype(np.float32)
    m = rng.standard_normal((8, 8)).astype(np.float32)
    before = X.KERNEL_LAUNCHES
    out = X.axis_apply(torch.as_tensor(u), torch.as_tensor(m))
    assert X.KERNEL_LAUNCHES == before  # CPU tensors never reach it
    ref = np.asarray(_jax_kern(jnp.asarray(u), jnp.asarray(m)), np.float64)
    err = np.max(np.abs(out.numpy() - ref)) / np.max(np.abs(ref))
    assert out.dtype == torch.float32 and err <= AXIS_TOL, err
    with pytest.raises(ValueError, match="CUDA"):
        X.axis_apply_cuda(torch.as_tensor(u), torch.as_tensor(m))


def _error(lines, pattern):
    for line in lines:
        found = re.search(pattern + r"\s*([0-9.eE+-]+)", line)
        if found:
            return float(found.group(1))
    raise AssertionError(f"no {pattern!r} in {lines}")


@pytest.mark.parametrize("mode,first", [
    ("fused", "rel err fused_f32 vs fast_f32:"),
    ("phases", "phaseA+gather:"),
    ("structured", "structured rel err vs fast_f32:"),
])
def test_time_fused_on_cpu(capsys, mode, first):
    assert time_fused.main(["--mode", mode, "--level", "1", "--deg", "2",
                            "--inner", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("time_fused mode=%s level=1 deg=2 E=8 inner=2 "
                        "device=cpu" % mode)
    assert lines[1].startswith(first)
    if mode == "phases":
        assert lines[2].startswith("phaseA only")
    else:
        assert _error(lines, "rel err [^:]*:") <= F32_TOL
        # the bf16 apply's error, as the JAX tool's first line: the bf16
        # rounding (3.2e-3 relative max here), far above f32's
        assert lines[2].startswith("bf16 rel err ")
        assert F32_TOL < _error(lines[2:], "bf16 rel err [^:]*:") <= 1e-2
        assert all("us/apply" in line for line in lines[3:])
    assert len(lines) == {"fused": 8, "phases": 3, "structured": 5}[mode]


def test_exp_kernel_design_on_cpu(capsys):
    found = torch.backends.cuda.matmul.allow_tf32
    assert X.main(["--device", "cpu", "--elements", "64"]) == 0
    assert torch.backends.cuda.matmul.allow_tf32 == found  # E1 restores it
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    tags = [line.split()[0] for line in lines[1:]]
    assert tags == ["E0", "E1", "E1", "E2", "E2", "E3", "E3", "E3", "E4"]
    assert "[4 MiB]" in lines[1] and "[64]^2" in lines[2]
    assert lines[-1].startswith("E4 plain 3-axis apply [64,8,8,8]")
    assert _error(lines, r"rel err vs plain \(one apply\)") == 0.0


def test_tools_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        time_fused.main(["--level", "1", "--deg", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        X.main(["--elements", "64"])


@pytest.mark.parametrize("name", sorted(ablate_sipg.VARIANTS))
def test_ablation_edits_match_the_tile_code(name):
    """Every ablation of `tools/ablate_sipg.py` still finds the source it
    edits in `csrc/sipg_gemm.cuh` (the timing itself needs the card), and
    is timed through the kernel it cuts: `base` through both, the bf16
    cuts through the bf16 entry point, the others through the f32 one."""
    text = ablate_sipg.edited_header(name)
    assert (text == (ablate_sipg.cuda_build.CSRC / ablate_sipg.HEADER)
            .read_text()) == (name == "base")
    assert ablate_sipg.precisions(name) == (
        ("f32", "bf16") if name == "base"
        else ("bf16",) if name.startswith("bf16_") else ("f32",))


def test_compare_sipg_cases_are_the_smoke_phases():
    """`tools/compare_sipg.py` holds the f32 kernels to a baseline on the
    inputs of `chip_smoke.py` phases 3 and 6; its lists are those."""
    import chip_smoke

    assert compare_sipg.B1_CASES == chip_smoke.CASES
    assert compare_sipg.B2_CASES == chip_smoke.FUSED_CASES


def test_compare_sipg_loads_a_checkout_s_pack():
    """The baseline's bf16 B comes from its own `laplacian/fused.py`: here
    this checkout's, which must pack as `fused.pack_sipg_weights_bf16`."""
    from disco4est_tpu_torch.geometry.brick import BrickGeometry
    from disco4est_tpu_torch.laplacian import fused
    from disco4est_tpu_torch.mesh.builder import build_mesh
    from disco4est_tpu_torch.mesh.tree import Forest

    root = compare_sipg.cuda_build.CSRC.parents[1]
    pack = compare_sipg.pack_of("test", root)
    geom = BrickGeometry(dim=3)
    fm = fused.build_fused(build_mesh(geom, Forest.uniform(geom.conn, 0),
                                      deg=3, device="cpu"))
    assert torch.equal(pack(fm.W_vol, fm.W_lift, fm.nblk), fm.W_pack_bf16)


def test_profile_solve_on_the_cpu(capsys):
    assert profile_solve.main(["--level", "1", "--deg", "1", "--rounds",
                               "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    runs = [line for line in lines if line.startswith("round 0:")]
    assert len(runs) == 2 and all("not a device run" in r for r in runs)
    assert profile_solve._union([(0, 2), (1, 3), (5, 6)]) == 4


def test_profile_solve_on_the_sphere_on_the_cpu(capsys):
    """`--geometry sphere7` solves on the 7-tree sphere; on the CPU
    `use_structured = auto` is off, so both runs take the generic mixed
    solve (the card's curved path needs `auto` on a CUDA device)."""
    assert profile_solve.main(["--geometry", "sphere7", "--level", "0",
                               "--deg", "2", "--rounds", "1", "--device",
                               "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("profile_solve geometry=sphere7 level=0 ")
    runs = [line for line in lines if line.startswith("round 0:")]
    assert len(runs) == 2 and all("path=mixed " in r for r in runs)
