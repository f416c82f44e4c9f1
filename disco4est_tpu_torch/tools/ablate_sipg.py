"""Where the fused SIPG kernel's time goes: ablations of `sipg_gemm.cuh`.

From the root of a checkout, on a machine with the card and `nvcc`:

    python -m disco4est_tpu_torch.tools.ablate_sipg [VARIANT ...]

Each variant is a copy of `csrc/` with parts of the shared tile code cut
out by source edits (`VARIANTS`), built into `build/ablate/<variant>/`
(one `nvcc` each, all at once) and timed through `fused_apply.cu` (B2) at
deg 3 / level 5 and deg 7 / level 4 on the unit cube: the median of 5
batches of 20 back-to-back launches between CUDA events, behind a spin
kernel, so the time is device time.  A variant that cuts work computes a
wrong result; its error against the plain version is printed only to
show which variants are the real kernel.

The f32 kernel (split-TF32 products, `sipg_gemm_kernel`):

- `base`: the kernel as it is (timed in f32 and in bf16);
- `no_gen`: A is not generated (the A tile keeps whatever it held);
- `no_fetch`: A's sources (u and the trace lanes) are not fetched;
- `no_mma`: no tensor-core products;
- `mma_only`: `no_gen` and `no_fetch`;
- `skeleton`: all three cut: what is left is the pipeline itself (B and
  table bulk copies, barriers, the promotion and the epilogue).

The bf16 kernel (`sipg_bf16_kernel`, timed through
`d4est_fused_apply_bf16`), the same cuts of its producers and consumers:
`bf16_no_gen`, `bf16_no_fetch`, `bf16_no_mma`, `bf16_no_b` (the B chunks
are not staged: the products read whatever the ring held) and
`bf16_skeleton` (generation, fetch and products cut: the ring's barriers,
the B and table copies, the scaling and the epilogue are left).
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from disco4est_tpu_torch.driver import resolve_device
from disco4est_tpu_torch.geometry.brick import BrickGeometry
from disco4est_tpu_torch.laplacian import fused
from disco4est_tpu_torch.mesh.builder import build_mesh
from disco4est_tpu_torch.mesh.tree import Forest
from disco4est_tpu_torch.util import cuda_build

HEADER = "sipg_gemm.cuh"
OUT_DIR = cuda_build.BUILD_DIR.parent / "ablate"
SIZES = ((3, 5), (7, 4))

_GEN = [(
    "    if (w.cc == 0) mbar_wait(&meta_bars[w.lt & 1], (w.lt >> 1) & 1);\n",
    "    if (w.cc == 0) mbar_wait(&meta_bars[w.lt & 1], (w.lt >> 1) & 1);\n"
    "    return;\n",
)]
_FETCH = [(
    "      const int k = w.c * kKC + kq * VEC;\n      if (k < C::KVOL) {",
    "      const int k = C::K;\n      if (k < C::KVOL) {",
)]
_MMA = [
    (f"        Wgmma<C::SW>::mma(part, tile_desc({a} + off), "
     f"tile_desc({b} + off),",
     f"        if (0) Wgmma<C::SW>::mma(part, tile_desc({a} + off), "
     f"tile_desc({b} + off),")
    for a, b in (("a_hi", "b_hi"), ("a_hi", "b_lo"), ("a_lo", "b_hi"))
]
_BF16_GEN = [(
    "      if (w.cc == 0) ring_wait(&meta_bar[w.lt & 1], (w.lt >> 1) & 1);\n",
    "      if (w.cc == 0) ring_wait(&meta_bar[w.lt & 1], (w.lt >> 1) & 1);\n"
    "      return;\n",
)]
_BF16_FETCH = [(
    "        const int kb = w.c * kKCB + kq * VEC;\n        if (kb < C::KVOL) {",
    "        const int kb = C::K;\n        if (kb < C::KVOL) {",
)]
_BF16_MMA = [("          WgmmaBf16<C::SW>::mma(",
              "          if (0) WgmmaBf16<C::SW>::mma(")]
_BF16_B = [("        bulk_load(reinterpret_cast<float*>(st + C::A_BYTES),",
            "        mbar_arrive(&full[s]);\n"
            "        if (0) bulk_load(reinterpret_cast<float*>(st + C::A_BYTES),")]
VARIANTS = {
    "base": [],
    "no_gen": _GEN,
    "no_fetch": _FETCH,
    "no_mma": _MMA,
    "mma_only": _GEN + _FETCH,
    "skeleton": _GEN + _FETCH + _MMA,
    "bf16_no_gen": _BF16_GEN,
    "bf16_no_fetch": _BF16_FETCH,
    "bf16_no_mma": _BF16_MMA,
    "bf16_no_b": _BF16_B,
    "bf16_skeleton": _BF16_GEN + _BF16_FETCH + _BF16_MMA,
}


def precisions(name: str):
    """The kernels a variant is timed in: its own, or both for `base`."""
    if name == "base":
        return ("f32", "bf16")
    return ("bf16",) if name.startswith("bf16_") else ("f32",)


def edited_header(name: str) -> str:
    """The tile code with variant `name`'s edits; raises if an edit no
    longer matches the source."""
    text = (cuda_build.CSRC / HEADER).read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old.strip()[:60]!r} is not "
                             f"in {HEADER}")
        text = text.replace(old, new)
    return text


def build(name: str) -> pathlib.Path:
    d = OUT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    (d / HEADER).write_text(edited_header(name))
    lib = d / "fused_apply.so"
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
           str(d / "fused_apply.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n"
                           + proc.stderr[-3000:])
    return lib


def _time_us(fn, n=20, reps=5):
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(1 << 24)
        ev[1].record()
        for _ in range(n):
            fn()
        ev[2].record()
        ev[2].synchronize()
        times.append(ev[1].elapsed_time(ev[2]) / n * 1e3)
    return sorted(times)[len(times) // 2]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    names = argv or list(VARIANTS)
    for name in names:
        edited_header(name)  # fail before building anything
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"ablate_sipg on {card}")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    torch.backends.cuda.matmul.allow_tf32 = False
    for deg, level in SIZES:
        geom = BrickGeometry(dim=3)
        mesh = build_mesh(geom, Forest.uniform(geom.conn, level), deg=deg,
                          device=dev)
        fm = fused.build_fused(mesh)
        E = mesh.n_elements
        u2 = torch.as_tensor(
            np.random.default_rng(0).standard_normal((E, fm.nv)),
            dtype=torch.float32, device=dev)
        ops = {}
        for p in ("f32", "bf16"):
            tr = fused.scaled_traces(u2, fm.W_tr, fm.drstn, p).contiguous()
            ops[p] = (tr, fm.W_pack_bf16 if p == "bf16" else fm.W_pack,
                      fused.fused_apply_plain(fm, u2, tr, p))
        stream = torch.cuda.current_stream().cuda_stream
        for name, path in libs.items():
            for p in precisions(name):
                tr, w_pack, ref = ops[p]
                out = torch.empty_like(ref)
                fn = getattr(ctypes.CDLL(str(path)), "d4est_fused_apply"
                             + ("_bf16" if p == "bf16" else ""))
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                    ctypes.c_void_p]

                def call(fn=fn, tr=tr, w_pack=w_pack, out=out, name=name):
                    err = fn(u2.data_ptr(), tr.data_ptr(),
                             fm.nbr_row.data_ptr(), fm.meta.data_ptr(),
                             w_pack.data_ptr(), out.data_ptr(), E, deg + 1,
                             fm.nblk, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                rel = float((out - ref).abs().max() / ref.abs().max())
                print(f"deg {deg} level {level} (E {E}) {p:4s} {name:13s}: "
                      f"{_time_us(call):8.2f} us  (rel err vs plain "
                      f"{rel:.2e})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
