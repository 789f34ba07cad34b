"""Disk-backed cache of derived index layouts.

Rationale (measured on the JAX package's TPU host, 2026-08-18): first-touch of
anonymous memory collapses to ~10-50 MB/s whenever a large-RSS process
exists (hypervisor ballooning), while file-backed page-cache faults
stay at ~3.5 GB/s — a ~78x gap. At GRCh38 scale the derived layouts
(padded reference text, merged FM gather table) are ~6 GB each, so
deriving them into anonymous memory costs tens of minutes of kernel
time per process, every process. Caching them next to the index files
and memory-mapping them read-only turns every later load into lazy
page-cache reads.

The reference loads everything eagerly into heap each run
(bwt_index.cpp bwa_idx_load:147); this cache plays the role of the
shared-memory index mode common in production aligners.

File format: 8-byte little-endian header length, a JSON header
(version, dtype, shape, plus caller metadata used as a validity key),
then the raw array bytes. Files are written atomically (tmp+rename);
a mismatched header (stale version, different index) is treated as a
miss and rewritten.
"""

from __future__ import annotations

import json
import os

import numpy as np

VERSION = 1
# only texts >= 1 Gbp pay enough fault time to be worth the disk; the
# toy/bench-small indexes load in milliseconds either way
CACHE_MIN_SEQ = 1 << 30


def eligible(seq_len: int) -> bool:
    return seq_len >= CACHE_MIN_SEQ


def _path(prefix: str, kind: str) -> str:
    return f"{prefix}.{kind}"


def save_array(prefix: str, kind: str, arr: np.ndarray, meta: dict) -> None:
    """Atomically write arr with a validity-key header. Best-effort:
    a full disk or read-only index directory just skips the cache."""
    path = _path(prefix, kind)
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            h = dict(meta, v=VERSION, dtype=str(arr.dtype),
                     shape=list(arr.shape))
            hb = json.dumps(h, sort_keys=True).encode()
            f.write(len(hb).to_bytes(8, "little"))
            f.write(hb)
            arr.tofile(f)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load_array(prefix: str, kind: str, want_meta: dict):
    """Return (read-only memmap, header) on a validity-key match, else
    (None, None)."""
    path = _path(prefix, kind)
    try:
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            if not 0 < n < 65536:
                return None, None
            h = json.loads(f.read(n))
    except (OSError, ValueError):
        return None, None
    if h.get("v") != VERSION:
        return None, None
    for k, v in want_meta.items():
        if h.get(k) != v:
            return None, None
    shape = tuple(h["shape"])
    expect = 8 + n + int(np.dtype(h["dtype"]).itemsize) * int(np.prod(shape))
    if os.path.getsize(path) != expect:
        return None, None  # truncated write
    arr = np.memmap(path, dtype=h["dtype"], mode="r", offset=8 + n,
                    shape=shape)
    return arr, h
