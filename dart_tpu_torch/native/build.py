"""Lazy build + load of the port's native library (C++, via g++).

The native library hosts the host-side hot paths that the reference
implements in C/C++ (suffix-array construction for the index builder,
the read packer, the chunk pipeline of chaining, gap closing and SAM
text, the BAM encoder and BGZF deflate, the wide table packers).
Compiled once into ``dart_tpu_torch/_build/`` as
``libdart_torch_native``, a name of its own, so that it never collides
with another package's build of the same sources in one process;
rebuilt when sources are newer. The BGZF deflate is built only where
zlib is found, so that a machine without it keeps the rest.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LOCK = threading.Lock()
_LIB = None

SOURCES = ["sais.cpp", "zoo.cpp", "pipeline.cpp", "pack.cpp", "bamenc.cpp",
           "layout.cpp", "fastx.cpp", "bgzf.cpp"]
ZLIB_SOURCES = {"bgzf.cpp"}  # built, and -lz linked, only where zlib is


def _tsan() -> bool:
    return os.environ.get("DART_TPU_TSAN") == "1"


def _lib_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    name = "libdart_torch_native_tsan" if _tsan() else "libdart_torch_native"
    return os.path.join(_BUILD, name + suffix)


def _needs_build(lib: str) -> bool:
    if not os.path.exists(lib):
        return True
    lib_mtime = os.path.getmtime(lib)
    for src in SOURCES:
        p = os.path.join(_HERE, src)
        if os.path.exists(p) and os.path.getmtime(p) > lib_mtime:
            return True
    return False


def _has_zlib(out: str) -> bool:
    """Whether g++ compiles and links a program against zlib here (the
    probe's binary goes to `out`, then away)."""
    probe = b"#include <zlib.h>\nint main() { return zlibVersion() == 0; }\n"
    p = subprocess.run(["g++", "-x", "c++", "-", "-lz", "-o", out],
                       input=probe, capture_output=True)
    if os.path.exists(out):
        os.remove(out)
    return p.returncode == 0


def build(force: bool = False) -> str:
    lib = _lib_path()
    with _LOCK:
        if force or _needs_build(lib):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"  # processes may build at once
            zlib = _has_zlib(tmp + ".zlib")
            srcs = [os.path.join(_HERE, s) for s in SOURCES
                    if os.path.exists(os.path.join(_HERE, s))
                    and (zlib or s not in ZLIB_SOURCES)]
            cmd = [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                "-pthread", *srcs, "-o", tmp, *(["-lz"] if zlib else []),
            ]
            if _tsan():
                # thread-sanitized build (separate artifact name, so
                # the production lib is untouched) for auditing the -t
                # pool
                cmd[1:1] = ["-fsanitize=thread", "-g", "-O1"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL | None:
    """Load (building if needed). Returns None if no C++ toolchain."""
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        _LIB = ctypes.CDLL(build())
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return None
    return _LIB
