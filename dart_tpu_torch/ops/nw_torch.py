"""Batched gap-closing DP on the card: the port of
``dart_tpu.ops.nw_pallas``.

``nw_planes`` launches the hand-written kernel of
``csrc/nw_kernels.cu`` for CUDA tensors (or raises), and runs the plain
PyTorch version of ``ops.nw_plain`` for CPU tensors. ``nw_align_batch``
is the counterpart of ``nw_pallas.nw_align_batch``: it codes a batch
of fragment pairs of up to 127 bases a side, computes their traceback
planes on ``device`` in one launch, and walks each pair's planes back
on the host. Its gapped strings equal ``ops.nw_numpy.nw_align`` (the
host C++ DP that production calls) for every pair.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..constants import NT4_TABLE
from . import build
from .nw_plain import LANES, MAX_LEN, PLANES, nw_plain

# kernel launches by name, added to where a kernel is launched; a
# caller that wants the launches of one run sets it to 0 first
launches = {"nw": 0}


def nw_planes(c1: torch.Tensor, c2: torch.Tensor,
              mn: torch.Tensor) -> torch.Tensor:
    """Traceback-choice planes (B, 32, 128) int32 of B fragment pairs:
    ``c1`` and ``c2`` (B, 128) int32 NT4 codes, ``mn`` (B, 2) int32
    lengths 0..127 (see ``ops.nw_plain``). One kernel launch on a CUDA
    device; the plain version on the CPU."""
    B = c1.shape[0] if c1.dim() else -1
    for name, t, width in (("c1", c1, LANES), ("c2", c2, LANES),
                           ("mn", mn, 2)):
        if (t.device != c1.device or t.dtype != torch.int32
                or tuple(t.shape) != (B, width) or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous ({B}, {width}) "
                             f"int32 tensor on {c1.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if c1.device.type == "cpu":
        return nw_plain(c1, c2, mn)
    if c1.device.type != "cuda":
        raise ValueError(f"unsupported device {c1.device}")
    out = torch.empty((B, PLANES, LANES), dtype=torch.int32,
                      device=c1.device)
    if B:
        rc = build.load().dart_nw_planes(
            c1.data_ptr(), c2.data_ptr(), mn.data_ptr(), B, out.data_ptr(),
            torch.cuda.current_stream(c1.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nw launch failed: CUDA error {rc}")
        launches["nw"] += 1
    return out


def pack_pairs(pairs: list[tuple[bytes, bytes]]):
    """NT4 codes and lengths of fragment pairs as (c1, c2, mn) int32
    numpy arrays of (B, 128), (B, 128), (B, 2); codes past a side's
    length are 4. Raises ValueError for a side longer than 127."""
    B = len(pairs)
    c1 = np.full((B, LANES), 4, np.int32)
    c2 = np.full((B, LANES), 4, np.int32)
    mn = np.zeros((B, 2), np.int32)
    for k, (s1, s2) in enumerate(pairs):
        if len(s1) > MAX_LEN or len(s2) > MAX_LEN:
            raise ValueError("fragment longer than 127 bases")
        c1[k, :len(s1)] = NT4_TABLE[np.frombuffer(s1, np.uint8)]
        c2[k, :len(s2)] = NT4_TABLE[np.frombuffer(s2, np.uint8)]
        mn[k] = (len(s1), len(s2))
    return c1, c2, mn


def traceback(planes: np.ndarray, s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
    """Walk one pair's (32, 128) planes back from (len(s1), len(s2))
    (nw_alignment.cpp:61-74): choice 1 is a gap in s1, 2 a gap in s2,
    0 the diagonal."""
    i, j = len(s1), len(s2)
    o1 = bytearray()
    o2 = bytearray()
    while i > 0 or j > 0:
        d = i + j
        c = (int(planes[d >> 3, i]) >> (2 * (d & 7))) & 3
        if c == 1:
            o1.append(ord("-"))
            o2.append(s2[j - 1])
            j -= 1
        elif c == 2:
            o1.append(s1[i - 1])
            o2.append(ord("-"))
            i -= 1
        else:
            o1.append(s1[i - 1])
            o2.append(s2[j - 1])
            i -= 1
            j -= 1
    o1.reverse()
    o2.reverse()
    return bytes(o1), bytes(o2)


def nw_align_batch(pairs: list[tuple[bytes, bytes]],
                   device="cuda") -> list[tuple[bytes, bytes]]:
    """Align a batch of fragment pairs, each side of at most 127 bases
    (ValueError otherwise), with one DP launch on ``device``; returns
    the gapped strings (b'-' gaps) of each pair, as ``nw_align`` does."""
    if not pairs:
        return []
    c1, c2, mn = (torch.from_numpy(a).to(device) for a in pack_pairs(pairs))
    planes = nw_planes(c1, c2, mn).cpu().numpy()
    return [traceback(planes[k], s1, s2) for k, (s1, s2) in enumerate(pairs)]


@contextlib.contextmanager
def recording_host_dp():
    """Record every fragment pair that the Python pipeline
    (``cfg.native = False``, or ``-d``) hands its host DP, ``nw_align``
    as ``pipeline.finalize`` and ``pipeline.cigar`` import it, while
    the host DP still answers. Yields the list the pairs are appended
    to; the two modules get their ``nw_align`` back on exit."""
    from ..pipeline import cigar, finalize

    pairs = []
    saved = {mod: mod.nw_align for mod in (finalize, cigar)}

    def recording(dp):
        def recorded(s1, s2):
            pairs.append((bytes(s1), bytes(s2)))
            return dp(s1, s2)
        return recorded

    try:
        for mod, fn in saved.items():
            mod.nw_align = recording(fn)
        yield pairs
    finally:
        for mod, fn in saved.items():
            mod.nw_align = fn
