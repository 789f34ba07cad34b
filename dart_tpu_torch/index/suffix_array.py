"""Suffix array construction: native SA-IS (preferred) or NumPy fallback.

Suffix order follows the BWA convention: an implicit sentinel smaller
than every character terminates the text, so shorter suffixes that are
prefixes of longer ones sort first.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import build as native_build


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array (int64, length n) of a uint8 code array (values 0..3)."""
    n = int(codes.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64)
    lib = native_build.load()
    if lib is not None:
        return _sais_native(lib, codes)
    return _sa_numpy(codes)


def _sais_native(lib: ctypes.CDLL, codes: np.ndarray) -> np.ndarray:
    n = int(codes.shape[0])
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sa = np.empty(n, dtype=np.int64)
    fn = lib.dart_sais_u8
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    K = int(codes.max()) + 2  # +1 for the code shift, +1 for sentinel
    rc = fn(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        K,
    )
    if rc != 0:
        raise RuntimeError("native sais failed")
    return sa


def _sa_numpy(codes: np.ndarray) -> np.ndarray:
    """Prefix-doubling (Manber-Myers) with np.lexsort. O(n log^2 n);
    fallback for environments without g++."""
    n = int(codes.shape[0])
    # rank with sentinel: shift codes by +1, out-of-range = 0
    rank = codes.astype(np.int64) + 1
    sa = np.argsort(rank, kind="stable")
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)  # -1 = past end (sentinel sorts first)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        # recompute ranks
        new_rank = np.empty(n, dtype=np.int64)
        prev = (rank[order][1:] != rank[order][:-1]) | (key2[order][1:] != key2[order][:-1])
        new_rank[order] = np.concatenate(([0], np.cumsum(prev)))
        rank = new_rank
        sa = order
        if rank.max() == n - 1:
            break
        k <<= 1
        if k >= n:
            break
    return sa.astype(np.int64)
