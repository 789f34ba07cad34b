"""Seconds from the process's start to the window's: imports, the
genome, the pool of reads, the index load, the engine and the warm-up.
The builds that a checkout's first run makes (the native library, the
index, the CUDA kernels) are left out and reported apart, under the
result line's ``builds``."""


def read(run):
    return run["setup_s"]
