"""Exact gap-closing DP (Needleman-Wunsch variant) host implementations.

Scoring mirrors Dart's src/nw_alignment.cpp:18-82 exactly,
including its overload-resolution quirk (verified against the compiled
reference): the r/t gap-matrix updates resolve to std::max<float>
(plain float max), while the 3-argument s update uses the custom
max(short, short, short) (nw_alignment.cpp:13-16) whose arguments are
truncated toward zero — so stored s values are integers while r/t keep
half-unit values.

Two implementations with identical results:
- nw_align: native C++ (native/zoo.cpp), the default
- nw_align_numpy: antidiagonal-vectorized NumPy; also the dataflow
  of the batched kernel (csrc/nw_kernels.cu, ops/nw_torch.py)
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..constants import NT4_TABLE
from ..native import build as native_build

OPEN_GAP = -1.0
EXTEND_GAP = -0.5
NEW_GAP = -1.5
MAXPEN = -65536.0

_nw_fn = None


def _get_native():
    global _nw_fn
    if _nw_fn is None:
        lib = native_build.load()
        if lib is None:
            return None
        fn = lib.dart_nw
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                       ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]
        _nw_fn = fn
    return _nw_fn


def nw_align(s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
    """Align two fragments; returns gapped strings (b'-' gaps)."""
    fn = _get_native()
    if fn is None:
        return nw_align_numpy(s1, s2)
    m, n = len(s1), len(s2)
    o1 = ctypes.create_string_buffer(m + n + 1)
    o2 = ctypes.create_string_buffer(m + n + 1)
    k = fn(s1, m, s2, n, o1, o2)
    return o1.raw[:k], o2.raw[:k]


def _trunc(x: np.ndarray) -> np.ndarray:
    """float -> short conversion as compiled: trunc toward zero (values
    stay in int32/short range on every reachable path)."""
    return np.trunc(x).astype(np.float32)


def nw_align_numpy(s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
    m, n = len(s1), len(s2)
    c1 = NT4_TABLE[np.frombuffer(s1, dtype=np.uint8)]
    c2 = NT4_TABLE[np.frombuffer(s2, dtype=np.uint8)]
    M, N = m + 1, n + 1
    r = np.zeros((M, N), dtype=np.float32)
    t = np.zeros((M, N), dtype=np.float32)
    s = np.zeros((M, N), dtype=np.float32)
    ii = np.arange(1, M, dtype=np.float32)
    jj = np.arange(1, N, dtype=np.float32)
    r[1:, 0] = MAXPEN
    s[1:, 0] = t[1:, 0] = OPEN_GAP + ii * EXTEND_GAP
    t[0, 1:] = MAXPEN
    s[0, 1:] = r[0, 1:] = OPEN_GAP + jj * EXTEND_GAP

    match = np.where(c1[:, None] == c2[None, :], np.float32(1.5), np.float32(-1.5))

    # antidiagonal sweep: cells (i, j) with i+j = d
    for d in range(2, m + n + 1):
        i_lo = max(1, d - n)
        i_hi = min(m, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        rv = np.maximum(r[i, j - 1] + EXTEND_GAP, s[i, j - 1] + NEW_GAP)
        tv = np.maximum(t[i - 1, j] + EXTEND_GAP, s[i - 1, j] + NEW_GAP)
        diag = _trunc(s[i - 1, j - 1] + match[i - 1, j - 1])
        sv = np.maximum(diag, np.maximum(_trunc(rv), _trunc(tv)))
        r[i, j] = rv
        t[i, j] = tv
        s[i, j] = sv

    # traceback (r branch first, then t — nw_alignment.cpp:61-74)
    out1 = bytearray()
    out2 = bytearray()
    i, j = m, n
    while i > 0 or j > 0:
        sv = s[i, j]
        if sv == r[i, j]:
            out1.append(ord("-"))
            out2.append(s2[j - 1])
            j -= 1
        elif sv == t[i, j]:
            out1.append(s1[i - 1])
            out2.append(ord("-"))
            i -= 1
        else:
            out1.append(s1[i - 1])
            out2.append(s2[j - 1])
            i -= 1
            j -= 1
    out1.reverse()
    out2.reverse()
    return bytes(out1), bytes(out2)
