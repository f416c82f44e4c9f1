"""Write `csrc/wgmma_tf32.cuh`: one wrapper per width N of the Hopper
tensor-core product `wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32`.

The instruction names each of its N/2 accumulator registers a thread as
its own inline-asm operand, so every width needs its own operand list;
this script writes them out.  Regenerate after changing `WIDTHS`:

    python -m disco4est_tpu_torch.util.gen_wgmma
"""

from __future__ import annotations

import pathlib

# the sub-block widths SW of `Cfg` in `sipg_gemm.cuh`, for nl = 2..8
WIDTHS = (8, 32, 64, 88, 112, 128)
OUT = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "wgmma_tf32.cuh"

HEAD = """\
// Generated by `python -m disco4est_tpu_torch.util.gen_wgmma`; do not edit.
//
// Wgmma<N>::mma(d, desc_a, desc_b, scale_d) issues
//     wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32
// for one warpgroup: D[64, N] (+)= A[64, 8] * B[8, N], A and B read from
// shared memory through their matrix descriptors (both K-major, as the
// instruction requires for 32-bit types), D in f32 registers, N/2 a
// thread.  scale_d = 0 overwrites D, 1 accumulates.  The caller brackets
// the products with wgmma.fence / commit_group / wait_group.

#pragma once

#include <cstdint>

namespace d4est {

template <int N>
struct Wgmma;
"""


def _spec(n: int) -> str:
    regs = n // 2
    names = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return f"""
template <>
struct Wgmma<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{regs}],
                                             uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
        "{{{names}}}, %{regs}, %{regs + 1}, p, 1, 1;\\n}}\\n"
        : {outs}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def render() -> str:
    body = "".join(_spec(n) for n in WIDTHS)
    return HEAD + body + "\n}  // namespace d4est\n"


def main() -> int:
    OUT.write_text(render())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
