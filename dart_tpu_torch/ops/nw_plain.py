"""Plain PyTorch version of the batched gap-closing DP kernel.

The yardstick of ``csrc/nw_kernels.cu``: the same inputs and the same
output, bit for bit, as ``dart_tpu.ops.nw_pallas._nw_kernel``. Cell
(i, j) of a pair's (m+1) x (n+1) matrix lives at (d = i + j, i); the
anti-diagonals are walked in order, each one a few tensor ops over all
pairs and all 128 rows at once.

Scoring is the reference's (nw_alignment.cpp:18-82), quirk included:
``r = max(r_left - 0.5, s_left - 1.5)`` and ``t`` likewise from above
in plain float, while ``s = max(trunc(s_diag +- 1.5), trunc(r),
trunc(t))`` truncates every argument toward zero. The traceback choice
of a cell is 1 if ``s == r``, else 2 if ``s == t``, else 0, compared
against the untruncated ``r`` and ``t``. Every value is a multiple of
0.5 below 2^17 in magnitude, so float32 is exact.

Inputs, one row per pair: ``c1`` (B, 128) and ``c2`` (B, 128) int32
NT4 codes of the two sides (each from column 0; N is 4), ``mn`` (B, 2)
int32 their lengths, 0..127. The TPU kernel's reversed, padded ``c2r``
layout and its lane roll were a TPU lane-alignment device; here
``c2[d - 1 - i]`` is read directly. Output: (B, 32, 128) int32 planes,
the choice of diagonal d and row i in bits 2*(d % 8) of [d // 8, i];
cells outside a pair's matrix, and every diagonal past m + n, hold 0.
"""

from __future__ import annotations

import torch

LANES = 128        # rows of a plane: fragments of up to 127 bases a side
MAX_LEN = LANES - 1
PLANES = 32        # 256 diagonals, 8 per int32 plane
EXTEND_GAP = -0.5
NEW_GAP = -1.5
OPEN_GAP = -1.0
MAXPEN = -65536.0
MATCH = 1.5


def nw_plain(c1: torch.Tensor, c2: torch.Tensor,
             mn: torch.Tensor) -> torch.Tensor:
    """Traceback-choice planes (B, 32, 128) int32 of the pairs (see the
    module docstring). Lengths are clamped to 0..127, as the kernel
    clamps them."""
    dev = c1.device
    B = c1.shape[0]
    planes = torch.zeros((B, PLANES, LANES), dtype=torch.int32, device=dev)
    if B == 0:
        return planes
    mn = mn.long().clamp(0, MAX_LEN)
    m, n = mn[:, :1], mn[:, 1:]
    lane = torch.arange(LANES, device=dev)[None, :]
    neg = torch.full((B, 1), MAXPEN, dtype=torch.float32, device=dev)

    def from_above(x):
        """x[i - 1] at row i (row 0 reads MAXPEN)."""
        return torch.cat([neg, x[:, :-1]], dim=1)

    a = torch.cat([c1[:, :1], c1[:, :-1]], dim=1).long()  # c1[i - 1]
    c2l = c2.long()
    s_pp = s_p = r_p = t_p = neg.expand(B, LANES)
    bits = torch.zeros((B, LANES), dtype=torch.int32, device=dev)
    for d in range(int((m + n).max()) + 1):
        r_raw = torch.maximum(r_p + EXTEND_GAP, s_p + NEW_GAP)
        t_raw = torch.maximum(from_above(t_p) + EXTEND_GAP,
                              from_above(s_p) + NEW_GAP)
        jm1 = d - 1 - lane                                # j - 1 = d - 1 - i
        b = c2l.gather(1, jm1.clamp(0, MAX_LEN).expand(B, LANES))
        hit = (a == b) & (jm1 >= 0) & (jm1 < n)
        mt = torch.where(hit, MATCH, -MATCH)
        diag = torch.trunc(from_above(s_pp) + mt)
        sv = torch.maximum(diag, torch.maximum(torch.trunc(r_raw),
                                               torch.trunc(t_raw)))
        choice = torch.where(sv == r_raw, 1, torch.where(sv == t_raw, 2, 0))
        edge = 0.0 if d == 0 else OPEN_GAP + d * EXTEND_GAP
        top, left = lane == 0, lane == d                  # (0, d) and (d, 0)
        s_new = torch.where(top | left, edge, sv)
        r_new = torch.where(top, edge, torch.where(left, MAXPEN, r_raw))
        t_new = torch.where(left, edge, torch.where(top, MAXPEN, t_raw))
        choice = torch.where(top, 1, torch.where(left, 2, choice))
        valid = (lane <= m) & (lane <= d) & (d - lane <= n)
        s_new = torch.where(valid, s_new, MAXPEN)
        bits |= torch.where(valid, choice, 0).int() << (2 * (d % 8))
        if d % 8 == 7:
            planes[:, d // 8] = bits
            bits = torch.zeros_like(bits)
        s_pp, s_p, r_p, t_p = s_p, s_new, r_new, t_new
    if d % 8 != 7:
        planes[:, d // 8] = bits
    return planes
