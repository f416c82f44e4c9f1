"""Seconds from the process's start to the end of the warm-up run:
imports, the CUDA context, the kernel libraries (built on a checkout's
first run), and one run of the cell's own job."""


def read(rec):
    return rec["setup_s"]
