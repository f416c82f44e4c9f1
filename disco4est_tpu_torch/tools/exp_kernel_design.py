"""Kernel-design probe on the card, with kernel B3 (three-axis apply).

Port of `tools/exp_kernel_design.py` (the round-3 design experiments).
From the root of a checkout:

    python -m disco4est_tpu_torch.tools.exp_kernel_design [--device cuda|cpu]
        [--elements 4096]

One line per experiment, each sized by `--elements` (4096, the default,
gives the JAX probe's sizes):

  E0  streaming bandwidth: an f32 multiply chain (`timing.measure_hbm_bw`)
      and a copy pair, over 64 KiB per element (256 MiB at 4096)
  E1  f32 matmul [n, n] @ [n, n], n = elements, with TF32 off and on
      (the TPU's precision modes), each with its rate and its error
      against the f64 numpy product; the TF32 flag is restored after
  E2  row gather and roll of a [6·elements, 128] f32 trace array
  E3  small-K products [64·elements, 8] @ [8, 8] and
      [4·elements, 128] @ [128, 128], and the three-axis apply in torch ops
  E4  kernel B3 (`csrc/axis_apply.cu`, replacing the Pallas `kern`) on
      u [elements, 8, 8, 8], m [8, 8]: its error against the plain version
      on one application, then a chain of 32 applications timed.  A
      standard-normal m applied 96 times overflows f32, so only one
      application is compared.

With `--device=cpu` every experiment runs its plain version and every time
is the CPU's.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from disco4est_tpu_torch.driver import resolve_device
from disco4est_tpu_torch.tools.timing import (
    measure_gemm_peak,
    measure_hbm_bw,
    timeit,
)
from disco4est_tpu_torch.util.cuda_build import check_operand, load_library

F32 = torch.float32
NL = 8
SOURCE = "axis_apply.cu"
CHAIN = 32

# Launch counter of the CUDA kernel: the wrapper adds one each time it
# launches the kernel, so a run can show that it went through it.
KERNEL_LAUNCHES = 0


def axis_apply_plain(u, m):
    """out[e,a,b,c] = Σ u[e,i,j,k]·m[i,a]·m[j,b]·m[k,c]: `v @ m` along
    axes 1, 2 and 3 in turn, as the Pallas `kern` writes it."""
    v = u
    for ax in (1, 2, 3):
        v = torch.movedim(torch.movedim(v, ax, -1) @ m, -1, ax)
    return v


@functools.lru_cache(maxsize=None)
def _load():
    lib = load_library(SOURCE)
    fn = lib.d4est_axis_apply
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def axis_apply_cuda(u, m):
    """The three-axis apply on the card: launches `csrc/axis_apply.cu`.
    u: contiguous f32 [E, 8, 8, 8], m: contiguous f32 [8, 8], both on one
    CUDA device; raises on anything else and on a failed launch."""
    global KERNEL_LAUNCHES
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"axis_apply_cuda needs CUDA tensors, got {dev}")
    E = u.shape[0]
    check_operand("u", u, (E, NL, NL, NL), dev, F32)
    check_operand("m", m, (NL, NL), dev, F32)
    if E == 0 or E * NL**3 >= 2**31:
        raise ValueError(f"axis kernel: unsupported element count {E}")
    if u.data_ptr() % 16 or m.data_ptr() % 16:
        raise ValueError("axis kernel: u and m must be 16-byte aligned")
    out = torch.empty_like(u)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _load().d4est_axis_apply(u.data_ptr(), m.data_ptr(),
                                       out.data_ptr(), E, stream)
    if err != 0:
        raise RuntimeError(f"axis kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def axis_apply(u, m):
    """The three-axis apply: the kernel on a CUDA tensor (or raise), the
    plain version on a CPU tensor."""
    if u.device.type == "cpu":
        return axis_apply_plain(u, m)
    return axis_apply_cuda(u, m)


def _chain(fn, n=CHAIN):
    def run(v, *rest):
        for _ in range(n):
            v = fn(v, *rest)
        return v
    return run


def e0_bandwidth(elements, device):
    mib = max(1, elements * 64 // 1024)
    n = mib * 1024 * 1024 // 4
    bw_mul = measure_hbm_bw(mbytes=mib, iters=CHAIN, device=device)
    x = torch.ones((n,), dtype=F32, device=device)
    y = torch.zeros((n,), dtype=F32, device=device)

    def copy_pair(a, b):
        for _ in range(CHAIN // 2):
            a, b = b + 1.0, a + 1.0
        return a, b

    bw_cp = 2 * n * 4 * CHAIN / timeit(copy_pair, x, y, device=device)
    print(f"E0 bw [{mib} MiB]: mul-chain {bw_mul / 1e9:.0f} GB/s, "
          f"copy-pair {bw_cp / 1e9:.0f} GB/s")


def e1_matmul_precision(n, device):
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal((n, n)) / np.sqrt(n)
    b64 = rng.standard_normal((n, n)) / np.sqrt(n)
    ref = a64 @ b64
    a = torch.as_tensor(a64, dtype=F32, device=device)
    b = torch.as_tensor(b64, dtype=F32, device=device)
    found = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            tf = measure_gemm_peak(F32, n=n, iters=CHAIN, device=device)
            one = (a @ b).double().cpu().numpy()
            err = np.max(np.abs(one - ref)) / np.max(np.abs(ref))
            print(f"E1 f32 matmul [{n}]^2 allow_tf32={tf32}: "
                  f"{tf / 1e12:.1f} TF/s, rel err {err:.2e}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = found


def e2_gather(elements, device):
    rows_n = elements * 6
    rng = np.random.default_rng(0)
    tr = torch.as_tensor(rng.standard_normal((rows_n, 128)), dtype=F32,
                         device=device)
    perm = torch.as_tensor(np.random.default_rng(1).permutation(rows_n),
                           device=device)
    nbytes = 2 * rows_n * 128 * 4
    for name, fn in (
        (f"row gather [{rows_n},128] f32", lambda v: v[perm] + 1.0),
        (f"roll [{rows_n},128]", lambda v: torch.roll(v, 6, 0) + 1.0),
    ):
        per = timeit(_chain(fn), tr, device=device) / CHAIN
        print(f"E2 {name}: {per * 1e6:.1f} us/pass, "
              f"{nbytes / per / 1e9:.0f} GB/s")


def e3_small_k(elements, device):
    rng = np.random.default_rng(0)
    mm = _chain(lambda v, m: v @ m)
    for rows, k in ((elements * 64, 8), (elements * 4, 128)):
        u = torch.as_tensor(rng.standard_normal((rows, k)), dtype=F32,
                            device=device)
        m = torch.as_tensor(rng.standard_normal((k, k)), dtype=F32,
                            device=device)
        per = timeit(mm, u, m, device=device) / CHAIN
        print(f"E3 [B,{k}]@[{k},{k}] B={rows}: {per * 1e6:.1f} us, "
              f"{2 * rows * k * k / per / 1e12:.2f} TF/s, "
              f"{2 * rows * k * 4 / per / 1e9:.0f} GB/s")
    u3 = torch.as_tensor(rng.standard_normal((elements, NL, NL, NL)),
                         dtype=F32, device=device)
    m8 = torch.as_tensor(rng.standard_normal((NL, NL)), dtype=F32,
                         device=device)
    per = timeit(_chain(axis_apply_plain), u3, m8, device=device) / CHAIN
    print(f"E3 torch 3-axis apply [{elements},8,8,8]: {per * 1e6:.1f} us, "
          f"{3 * 2 * elements * NL**4 / per / 1e12:.2f} TF/s useful")


def e4_axis_kernel(elements, device):
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal((elements, NL, NL, NL)),
                        dtype=F32, device=device)
    m = torch.as_tensor(rng.standard_normal((NL, NL)), dtype=F32,
                        device=device)
    ref = axis_apply_plain(u, m)
    err = float((axis_apply(u, m) - ref).abs().max() / ref.abs().max())
    per = timeit(_chain(axis_apply), u, m, device=device) / CHAIN
    name = "cuda" if device.type == "cuda" else "plain"
    print(f"E4 {name} 3-axis apply [{elements},8,8,8]: {per * 1e6:.1f} us, "
          f"{3 * 2 * elements * NL**4 / per / 1e12:.2f} TF/s useful, "
          f"{2 * elements * NL**3 * 4 / per / 1e9:.0f} GB/s io; "
          f"rel err vs plain (one apply) {err:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--elements", type=int, default=4096)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")
    e0_bandwidth(args.elements, device)
    e1_matmul_precision(args.elements, device)
    e2_gather(args.elements, device)
    e3_small_k(args.elements, device)
    e4_axis_kernel(args.elements, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
