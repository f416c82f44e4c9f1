"""Compare the SIPG kernels (B1, B2) of this checkout with another's.

From the root of a checkout, on a machine with the card and `nvcc`:

    python -m disco4est_tpu_torch.tools.compare_sipg --baseline DIR
        [--sizes 7/4,3/5]

where DIR is the root of another checkout of the repository (for example
`git archive` of an earlier commit unpacked into `_archive/`).  Both
trees' `structured_apply.cu` (B1) and `fused_apply.cu` (B2) are built
with the same flags into `build/compare/` (four `nvcc` at once) and
called through their C entry points, each tree's bf16 kernels with the B
of its own `pack_sipg_weights_bf16` (read from DIR's `laplacian/fused.py`
for the baseline).

- f32: both trees' f32 kernels on the inputs of `chip_smoke.py` phases 3
  (B1) and 6 (B2), the same seeds; prints whether the outputs are equal
  bit for bit.
- Timing at each `--sizes` deg/level on the unit cube (by default deg 7
  / level 4 and deg 3 / level 5, the timed sizes of `chip_smoke.py`): B1
  and B2 in f32 and bf16 of both trees, in 6 alternating rounds
  (baseline, this, this, baseline, ...), each the median of the rounds'
  device times of 20 back-to-back calls behind a spin kernel; and each bf16
  kernel's relative L2 error against its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from disco4est_tpu_torch.driver import resolve_device
from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.laplacian import structured as S
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.util import cuda_build

OUT_DIR = cuda_build.BUILD_DIR.parent / "compare"
ROUNDS = 6
SOURCES = ("structured_apply.cu", "fused_apply.cu")
# `chip_smoke.py`'s CASES (phase 3, B1: deg, level, x1) and FUSED_CASES
# (phase 6, B2: deg, level, x1, trees per axis)
B1_CASES = [
    (1, 2, (1.0, 1.0, 1.0)), (2, 1, (1.0, 1.0, 1.0)),
    (7, 1, (1.0, 1.0, 1.0)), (3, 2, (1.0, 1.0, 1.0)),
    (7, 4, (1.0, 1.0, 1.0)), (3, 5, (1.0, 1.0, 1.0)),
    (2, 1, (1.0, 2.0, 4.0)),
]
B2_CASES = [
    (2, 1, (1.0, 1.0, 1.0), (1, 1, 1)), (3, 1, (1.0, 1.0, 1.0), (1, 1, 1)),
    (7, 1, (1.0, 1.0, 1.0), (1, 1, 1)), (3, 1, (2.0, 1.0, 0.5), (1, 1, 1)),
    (7, 4, (1.0, 1.0, 1.0), (1, 1, 1)), (3, 5, (1.0, 1.0, 1.0), (1, 1, 1)),
    (3, 3, (2.0, 2.0, 2.0), (2, 2, 2)), (7, 1, (3.0, 1.0, 1.0), (3, 1, 1)),
    (3, 1, (3.0, 3.0, 2.0), (3, 3, 2)),
]


def build(csrc: pathlib.Path, tag: str, source: str) -> pathlib.Path:
    d = OUT_DIR / tag
    d.mkdir(parents=True, exist_ok=True)
    lib = d / source.replace(".cu", ".so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
           str(csrc / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {tag}/{source}:\n"
                           + proc.stderr[-3000:])
    return lib


def pack_of(tag, root):
    """`pack_sipg_weights_bf16` of the checkout at `root` (its
    `laplacian/fused.py`, loaded as a module of its own)."""
    spec = importlib.util.spec_from_file_location(
        f"_fused_{tag}",
        pathlib.Path(root) / "disco4est_tpu_torch/laplacian/fused.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # (its dataclasses look it up)
    spec.loader.exec_module(mod)
    return mod.pack_sipg_weights_bf16


class Tree:
    """One checkout's two SIPG libraries and its bf16 pack."""

    def __init__(self, tag, root, libs):
        self.tag = tag
        s, f = (ctypes.CDLL(str(libs[(tag, src)])) for src in SOURCES)
        for fn in (s.d4est_structured_apply, s.d4est_structured_apply_bf16):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
        for fn in (f.d4est_fused_apply, f.d4est_fused_apply_bf16):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        self.s, self.f = s, f
        self.pack_bf16 = pack_of(tag, root)

    def b1(self, sb, u, tr, w_pack, bf16):
        fn = (self.s.d4est_structured_apply_bf16 if bf16
              else self.s.d4est_structured_apply)
        out = torch.empty_like(u)
        delta = (ctypes.c_int * 6)(*sb.deltas)
        opp = (ctypes.c_int * 6)(*sb.opp)
        err = fn(u.data_ptr(), tr.data_ptr(), sb.meta.data_ptr(),
                 w_pack.data_ptr(), out.data_ptr(), sb.n_elements,
                 sb.deg + 1, sb.nblk, delta, opp,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.tag} B1: CUDA error {err}")
        return out

    def b2(self, fm, u, tr, w_pack, bf16):
        fn = (self.f.d4est_fused_apply_bf16 if bf16
              else self.f.d4est_fused_apply)
        out = torch.empty_like(u)
        err = fn(u.data_ptr(), tr.data_ptr(), fm.nbr_row.data_ptr(),
                 fm.meta.data_ptr(), w_pack.data_ptr(), out.data_ptr(),
                 fm.n_elements, fm.deg + 1, fm.nblk,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.tag} B2: CUDA error {err}")
        return out


def _time_ms(fn, n=20):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(1 << 24)
    ev[1].record()
    for _ in range(n):
        fn()
    ev[2].record()
    ev[2].synchronize()
    return ev[1].elapsed_time(ev[2]) / n


def _mesh(deg, level, x1=(1.0, 1.0, 1.0), trees=(1, 1, 1), dev="cuda"):
    geom = BrickGeometry(x1=x1, n_trees_per_dim=trees, dim=3)
    return build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                      device=dev)


def f32_bit_equal(trees, dev):
    """Both trees' f32 kernels on phase 3's and phase 6's inputs."""
    base, this = trees
    same = True
    for deg, level, x1 in B1_CASES:
        sb = S.build_structured(_mesh(deg, level, x1, dev=dev))
        rng = np.random.default_rng(1000 * deg + level)
        u = torch.as_tensor(rng.standard_normal((sb.n_elements, sb.nv)),
                            dtype=torch.float32, device=dev)
        tr = S.compute_traces_lex(sb, u).contiguous()
        eq = torch.equal(base.b1(sb, u, tr, sb.W_pack, False),
                         this.b1(sb, u, tr, sb.W_pack, False))
        same &= eq
        print(f"f32 B1 deg {deg} level {level} x1 {x1}: "
              f"{'bit-equal' if eq else 'DIFFERENT'}")
    for deg, level, x1, tr_ in B2_CASES:
        mesh = _mesh(deg, level, x1, tr_, dev)
        fm = fused.build_fused(mesh)
        nl = deg + 1
        rng = np.random.default_rng(1000 * deg + level)
        u = torch.as_tensor(rng.standard_normal((fm.n_elements,) + (nl,) * 3),
                            dtype=torch.float32, device=dev)
        u2 = u.reshape(fm.n_elements, -1)
        tr = fused.scaled_traces(u2, fm.W_tr, fm.drstn).contiguous()
        eq = torch.equal(base.b2(fm, u2, tr, fm.W_pack, False),
                         this.b2(fm, u2, tr, fm.W_pack, False))
        same &= eq
        print(f"f32 B2 deg {deg} level {level} x1 {x1} trees {tr_}: "
              f"{'bit-equal' if eq else 'DIFFERENT'}")
    print(f"f32 kernels bit-equal on all {len(B1_CASES) + len(B2_CASES)} "
          f"cases: {'yes' if same else 'NO'}")
    return same


def timing(trees, deg, level, rounds, dev):
    mesh = _mesh(deg, level, dev=dev)
    sb, fm = S.build_structured(mesh), fused.build_fused(mesh)
    E = mesh.n_elements
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (E, sb.nv)), dtype=torch.float32, device=dev)
    trl = {p: S.compute_traces_lex(sb, u, p).contiguous()
           for p in ("f32", "bf16")}
    trf = {p: fused.scaled_traces(u, fm.W_tr, fm.drstn, p).contiguous()
           for p in ("f32", "bf16")}
    plain = {"B1": S.lex_apply_plain(sb, u, trl["bf16"], "bf16"),
             "B2": fused.fused_apply_plain(fm, u, trf["bf16"], "bf16")}
    fns = {}
    for t in trees:
        wb = {"B1": t.pack_bf16(sb.W_vol, sb.W_lift, sb.nblk),
              "B2": t.pack_bf16(fm.W_vol, fm.W_lift, fm.nblk)}
        for p in ("f32", "bf16"):
            bf = p == "bf16"
            fns[(t.tag, "B1", p)] = (
                lambda t=t, p=p, bf=bf, w=wb["B1"] if bf else sb.W_pack:
                t.b1(sb, u, trl[p], w, bf))
            fns[(t.tag, "B2", p)] = (
                lambda t=t, p=p, bf=bf, w=wb["B2"] if bf else fm.W_pack:
                t.b2(fm, u, trf[p], w, bf))
    for key, fn in fns.items():
        if key[2] == "bf16":
            out = fn()
            torch.cuda.synchronize()
            ref = plain[key[1]]
            rel = float(torch.linalg.norm((out - ref).double())
                        / torch.linalg.norm(ref.double()))
            print(f"deg {deg} level {level} {key[0]} {key[1]} bf16 vs plain "
                  f"bf16: rel L2 {rel:.3e}")
        fn()
    torch.cuda.synchronize()
    kinds = sorted({k[1:] for k in fns})
    tags = [t.tag for t in trees]
    t = {k: [] for k in fns}
    for r in range(rounds):
        order = tags if r % 2 == 0 else tags[::-1]
        for kind in kinds:
            for tag in order:
                t[(tag,) + kind].append(_time_ms(fns[(tag,) + kind]))
    for kind in kinds:
        med = {tag: sorted(t[(tag,) + kind])[rounds // 2] for tag in tags}
        print(f"deg {deg} level {level} (E {E}) {kind[0]} {kind[1]}: "
              + ", ".join(f"{tag} {med[tag]:.4f} ms" for tag in tags)
              + f" (this / {tags[0]} {med[tags[1]] / med[tags[0]]:.3f})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="root of the other checkout")
    ap.add_argument("--sizes", default="7/4,3/5",
                    help="deg/level pairs to time, comma-separated")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"compare_sipg on {card}: baseline {args.baseline}")
    roots = {"baseline": pathlib.Path(args.baseline).resolve(),
             "this": cuda_build.CSRC.parents[1]}
    jobs = [(tag, src) for tag in roots for src in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda j: build(roots[j[0]] / "disco4est_tpu_torch/csrc", *j),
            jobs)))
    trees = [Tree(tag, roots[tag], libs) for tag in roots]
    same = f32_bit_equal(trees, dev)
    for size in args.sizes.split(","):
        deg, level = (int(x) for x in size.split("/"))
        timing(trees, deg, level, ROUNDS, dev)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
