"""Build and load the port's CUDA C++ kernels.

Each kernel source under `disco4est_tpu_torch/csrc/` exposes a plain C
interface.  At first use it is compiled with `nvcc` for Hopper
(`sm_90a`) into a shared library under `build/kernels/` at the root of
the checkout, named by a hash of the source and the flags, and loaded
with `ctypes`.  A later call with the same source (and the same shared
headers, `csrc/*.cuh`) reuses the library.  `build_all` starts one
`nvcc` per source, all at once.  The compiler's report (registers,
shared memory, spills from `-Xptxas -v`) is kept beside it as a `.log`
file.  `check_operand` is the operand check of every kernel wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    fallback = fallback / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> pathlib.Path:
    """Where the library built from `csrc/<source>` lives."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def build(source: str) -> pathlib.Path:
    """Compile `csrc/<source>` unless its library already exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            + proc.stderr[-4000:]
        )
    os.replace(tmp, out)
    return out


def build_all(sources) -> dict:
    """Build several sources at once, one `nvcc` each, all started
    together; returns the seconds each build took."""

    def timed(source):
        t0 = time.perf_counter()
        build(source)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(zip(sources, pool.map(timed, sources)))


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<source>`."""
    return ctypes.CDLL(str(build(source)))


def check_operand(name, t, shape, device, dtype):
    """A kernel wrapper's check of one operand: a contiguous `dtype`
    tensor of `shape` on `device`; raises ValueError otherwise."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
