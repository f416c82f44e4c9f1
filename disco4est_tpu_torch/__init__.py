"""disco4est_tpu_torch — the PyTorch/CUDA port of `disco4est_tpu`.

A second package beside the JAX one, with the same module layout
(`ops/`, `quadrature/`, `mesh/`, `geometry/`, `laplacian/`, `solvers/`,
`io/`, `problems/`, `util/`, `driver.py`, `__main__.py`); each module's
docstring names its JAX counterpart, which stays the reference it is
tested against.  Plain tensor code is PyTorch with explicit devices and
dtypes (the global default dtype is never changed); the TPU's Pallas
kernels become kernels written by hand for NVIDIA Hopper, under `csrc/`.
This package never imports JAX or `disco4est_tpu`.
"""
