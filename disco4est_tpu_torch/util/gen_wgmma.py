"""Write the wgmma wrappers of the SIPG kernels: one per width N of the
Hopper tensor-core products

    wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32    (`csrc/wgmma_tf32.cuh`)
    wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16   (`csrc/wgmma_bf16.cuh`)

The instruction names each of its N/2 accumulator registers a thread as
its own inline-asm operand, so every width needs its own operand list;
this script writes them out.  Regenerate after changing `WIDTHS`:

    python -m disco4est_tpu_torch.util.gen_wgmma
"""

from __future__ import annotations

import pathlib

# the sub-block widths SW of `Cfg` in `sipg_gemm.cuh`, for nl = 2..8 (the
# same in both operand precisions)
WIDTHS = (8, 32, 64, 88, 112, 128)
CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
OUT = CSRC / "wgmma_tf32.cuh"
OUT_BF16 = CSRC / "wgmma_bf16.cuh"

# per operand type: (struct, K depth, types, trailing immediates, shapes,
# the header's lines on the operands); bf16 takes two more immediates, the
# transpose flags (0: both operands K-major, as the tf32 form requires)
KINDS = {
    "tf32": ("Wgmma", 8, "tf32.tf32", "p, 1, 1",
             "A[64, 8] * B[8, N]",
             "// shared memory through their matrix descriptors (both K-major, "
             "as the\n// instruction requires for 32-bit types), D in f32 "
             "registers, N/2 a"),
    "bf16": ("WgmmaBf16", 16, "bf16.bf16", "p, 1, 1, 0, 0",
             "A[64, 16] * B[16, N]",
             "// shared memory through their matrix descriptors (both K-major: "
             "the\n// transpose flags are 0), D in f32 registers, N/2 a"),
}

HEAD = """\
// Generated by `python -m disco4est_tpu_torch.util.gen_wgmma`; do not edit.
//
// {struct}<N>::mma(d, desc_a, desc_b, scale_d) issues
//     wgmma.mma_async.sync.aligned.m64nNk{k}.f32.{types}
// for one warpgroup: D[64, N] (+)= {shapes}, A and B read from
{operands}
// thread.  scale_d = 0 overwrites D, 1 accumulates.  The caller brackets
// the products with wgmma.fence / commit_group / wait_group.

#pragma once

#include <cstdint>

namespace d4est {{

template <int N>
struct {struct};
"""


def _spec(kind: str, n: int) -> str:
    struct, k, types, imm, _, _ = KINDS[kind]
    regs = n // 2
    names = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return f"""
template <>
struct {struct}<{n}> {{
  static __device__ __forceinline__ void mma(float (&d)[{regs}],
                                             uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k{k}.f32.{types} "
        "{{{names}}}, %{regs}, %{regs + 1}, {imm};\\n}}\\n"
        : {outs}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def render(kind: str = "tf32") -> str:
    struct, k, types, _, shapes, operands = KINDS[kind]
    head = HEAD.format(struct=struct, k=k, types=types, shapes=shapes,
                       operands=operands)
    body = "".join(_spec(kind, n) for n in WIDTHS)
    return head + body + "\n}  // namespace d4est\n"


def main() -> int:
    OUT.write_text(render("tf32"))
    OUT_BF16.write_text(render("bf16"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
