"""Kernel-timing tools of the port (counterparts of the JAX repo's
`tools/time_pallas.py` and `tools/exp_kernel_design.py`)."""
