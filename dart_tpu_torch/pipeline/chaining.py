"""Greedy diagonal chaining of gPos-sorted seeds into alignment
candidates (reference: GenerateAlignmentCandidate,
AlignmentCandidates.cpp:241-288)."""

from __future__ import annotations

from ..index.loader import Index
from .structs import AlignmentCandidate, SeedPair


def generate_alignment_candidates(idx: Index, cfg, rlen: int,
                                  seeds: list[SeedPair]) -> list[AlignmentCandidate]:
    out: list[AlignmentCandidate] = []
    num = len(seeds)
    if num == 0:
        return out
    thr = int(rlen * 0.3)
    i = 0
    while i < num and seeds[i].PosDiff < 0:
        i += 1
    while i < num:
        can = AlignmentCandidate()
        can.Score = seeds[i].rLen
        can.SeedVec = [seeds[i]]
        j = i
        k = i + 1
        while k < num:
            pos_diff = abs(seeds[k].PosDiff - seeds[j].PosDiff)
            if pos_diff < cfg.max_gaps or (
                pos_diff < cfg.max_intron_size
                and seeds[k].gPos < int(idx.chr_end_keys[idx.chr_lower_bound(seeds[j].gPos)])
                and seeds[k].rPos > seeds[j].rPos
            ):
                can.Score += seeds[k].rLen
                can.SeedVec.append(seeds[k])
                j = k
                k += 1
            else:
                break
        if can.Score > thr:
            can.PosDiff = can.SeedVec[0].PosDiff
            if can.PosDiff < 0:
                can.PosDiff = 0
            out.append(can)
        i = k
    return out
