"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each source to an object file, all at once in
parallel processes, and links them into one shared library with a plain
C interface, loaded with ``ctypes``; no PyTorch header is compiled, so
the build takes seconds. The library lands in ``dart_tpu_torch/_build/``
under a name keyed on a hash of the sources and the flags, so an edit
to a kernel builds anew and an unchanged tree reuses its build. A build
that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
SOURCES = ("fm_kernels.cu", "nw_kernels.cu", "probe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def lib_path(csrc: str = CSRC, sources=SOURCES) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sources:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdart_fm_{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel processes; raise with the output of
    each that failed, once all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    fails = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            fails.append(f"({proc.returncode}) {' '.join(cmd)}\n{out}")
    if fails:
        raise RuntimeError("nvcc failed:\n" + "\n".join(fails))


def build(csrc: str = CSRC, sources=SOURCES) -> tuple[str, float]:
    """Compile the sources (default: the package's) unless this exact
    build exists. Returns the library's path and the seconds spent
    compiling (0 if reused)."""
    lib = lib_path(csrc, sources)
    with _LOCK:
        if os.path.exists(lib):
            return lib, 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{s}.o" for s in sources]
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        try:
            # one compiler process per source, all running at once
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                       os.path.join(csrc, src)]
                      for src, obj in zip(sources, objs)])
            _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
            os.replace(tmp, lib)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        return lib, time.perf_counter() - t0


def ptxas_report(path: str) -> str:
    """What ``nvcc -Xptxas -v`` says of the source at ``path``: each
    kernel's registers, stack frame, spills and shared memory."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    obj = os.path.join(BUILD_DIR, f"ptxas.{os.getpid()}.o")
    try:
        out = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v",
                              "-c", "-o", obj, path], capture_output=True,
                             text=True, check=True)
    finally:
        if os.path.exists(obj):
            os.remove(obj)
    return out.stdout + out.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C entries typed.
    The wide entries take their parameter array and their row count as
    int64: positions and counts there pass 2^31. Each ``dart_fm_*``
    entry has a ``*_sharded`` twin that reads a range-sharded table."""
    return typed(ctypes.CDLL(build()[0]))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of each C entry it
    has set."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ip, lp = ctypes.POINTER(i32), ctypes.POINTER(i64)
    for name, args in {
        # table, params, lut, lut_k, buf, R, words, S, out, stream
        "dart_fm_seed_scan": [vp, ip, vp, i32, vp, i32, i32, i32, vp, vp],
        "dart_fm_seed_scan_wide": [vp, lp, vp, i32, vp, i32, i32, i32, vp,
                                   vp],
        # table, params, rows, n, out, stream
        "dart_fm_locate": [vp, ip, vp, i32, vp, vp],
        "dart_fm_locate_wide": [vp, lp, vp, i64, vp, vp],
        # table, params, K, out, stream
        "dart_fm_lut_build": [vp, ip, i32, vp, vp],
        "dart_fm_lut_build_wide": [vp, lp, i32, vp, vp],
        # table, params, chars, valid, W, L, lens, x0, x2, stream
        "dart_fm_mem_walks": [vp, ip, vp, vp, i32, i32, vp, vp, vp, vp],
        # c1, c2, mn, B, planes, stream
        "dart_nw_planes": [vp, vp, vp, i32, vp, vp],
        # device, peer
        "dart_enable_peer_access": [i32, i32],
        # buf, steps, start, out, stream
        "dart_probe_chase": [vp, i64, ctypes.c_uint32, vp, vp],
    }.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = args
        if name.startswith("dart_fm_"):
            # the range-sharded twin: (shard bases, rows a shard) in place
            # of the table
            fn = getattr(lib, name + "_sharded")
            fn.restype = i32
            fn.argtypes = [vp, i64, *args[1:]]
    return lib
