"""Time the fused SIPG apply (kernel B2) against the GEMM-form apply.

Port of `tools/time_pallas.py`.  From the root of a checkout:

    python -m disco4est_tpu_torch.tools.time_fused [--mode fused|phases|structured]
        [--level 4] [--deg 7] [--inner 256] [--device cuda|cpu]

on a uniform brick of that level and degree, in f32.  Modes (the JAX
tool's `main`, `phases` and `structured`):

- `fused`: the relative error of `fused.apply_sipg_fused` against the f32
  GEMM-form apply (`fast._apply_orth`); per-apply µs and GDOF/s of
  `fast_f32` and `fused_f32` (B2's whole apply, trace GEMM included); and
  B2's fused pass alone, given the traces.  The JAX tool's `pallas_bf16`
  row waits for the reduced-precision kernels (ROADMAP B4).
- `phases`: phase A (trace GEMM and scaling) plus the neighbor-row gather,
  and phase A alone.
- `structured`: the structured apply (kernel B1) against `_apply_orth`.

Every time is per apply: a chain of `--inner` applies timed by
`timing.timeit`.  With `--device=cpu` every apply takes its plain version,
and the times are the CPU's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from disco4est_tpu_torch.driver import resolve_device
from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.laplacian import structured as S
from disco4est_tpu_torch.laplacian.fast import _apply_orth
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.tools.timing import timeit


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _chain(fn, inner):
    """v ← fn(v), `inner` times (the JAX tool's `fori_loop`)."""
    def run(v):
        for _ in range(inner):
            v = fn(v)
        return v
    return run


def _repeat(fn, inner):
    """fn(*args), `inner` times on the same inputs."""
    def run(*args):
        for _ in range(inner):
            fn(*args)
    return run


def _row(name, dt, dof):
    print(f"{name:12s}: {dt * 1e6:8.1f} us/apply   {dof / dt / 1e9:7.2f} GDOF/s")


def run_fused(mesh, u, inner, device):
    E = mesh.n_elements
    fm = fused.build_fused(mesh)
    ref = _apply_orth(mesh, u)
    out = fused.apply_fused(fm, u)
    print(f"rel err fused_f32 vs fast_f32: {_rel(out, ref):.3e}")
    dof = u.numel()
    for name, fn in (("fast_f32", lambda v: _apply_orth(mesh, v)),
                     ("fused_f32", lambda v: fused.apply_fused(fm, v))):
        _row(name, timeit(_chain(fn, inner), u, device=device) / inner, dof)
    u2 = u.reshape(E, -1)
    tr = fused.scaled_traces(u2, fm.W_tr, fm.drstn)
    pass_fn = (fused.fused_apply_cuda if device.type == "cuda"
               else fused.fused_apply_plain)
    dt = timeit(_repeat(pass_fn, inner), fm, u2, tr, device=device) / inner
    _row("fused_pass", dt, dof)


def run_phases(mesh, u, inner, device):
    fm = fused.build_fused(mesh)
    u2 = u.reshape(mesh.n_elements, -1)

    def phase_a(v):
        return fused.scaled_traces(v, fm.W_tr, fm.drstn)

    def phase_a_gather(v):
        return fused.gather_rows(fm, phase_a(v))

    dt = timeit(_repeat(phase_a_gather, inner), u2, device=device) / inner
    print(f"phaseA+gather: {dt * 1e6:8.1f} us")
    dt = timeit(_repeat(phase_a, inner), u2, device=device) / inner
    print(f"phaseA only  : {dt * 1e6:8.1f} us")


def run_structured(mesh, u, inner, device):
    sb = S.build_structured(mesh)
    if sb is None:
        raise ValueError("structured path unavailable")
    E = mesh.n_elements
    u_lex = S.to_lex(sb, u.reshape(E, -1))
    ref = _apply_orth(mesh, u).reshape(E, -1)
    out = S.from_lex(sb, S.apply_structured(sb, u_lex))
    print(f"structured rel err vs fast_f32: {_rel(out, ref):.3e}")
    fn = _chain(lambda v: S.apply_structured(sb, v), inner)
    _row("structured", timeit(fn, u_lex, device=device) / inner, u.numel())


MODES = {"fused": run_fused, "phases": run_phases,
         "structured": run_structured}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="fused")
    ap.add_argument("--level", type=int, default=4)
    ap.add_argument("--deg", type=int, default=7)
    ap.add_argument("--inner", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    geom = BrickGeometry(dim=3)
    mesh = build_mesh(geom, Forest.uniform(geom.conn, args.level),
                      deg=args.deg, device=device).astype(torch.float32)
    E, nl = mesh.n_elements, args.deg + 1
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal((E,) + (nl,) * 3),
                        dtype=torch.float32, device=device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"time_fused mode={args.mode} level={args.level} deg={args.deg} "
          f"E={E} inner={args.inner} device={name}")
    MODES[args.mode](mesh, u, args.inner, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
