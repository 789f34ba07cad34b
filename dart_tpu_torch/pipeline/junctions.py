"""Splice-junction table accumulation and output
(reference: Mapping.cpp:532-577, 683-716)."""

from __future__ import annotations

from ..index.loader import Index
from .structs import AlignmentCandidate


def update_sj_map(idx: Index, min_intron: int, can: AlignmentCandidate,
                  sj_map: dict) -> None:
    """UpdateLocalSJMap (Mapping.cpp:532-565): record junctions at
    acceptor-marked seeds, in forward-genome coordinates."""
    if can.SJtype == -1:
        return
    seeds = can.SeedVec
    G2 = idx.seq_len
    for i in range(1, len(seeds)):
        if not seeds[i].bAcceptorSite:
            continue
        if can.PosDiff < idx.genome_size:
            g1 = seeds[i - 1].gPos + seeds[i - 1].gLen
            g2 = seeds[i].gPos - 1
        else:
            g1 = G2 - seeds[i].gPos
            g2 = G2 - 1 - (seeds[i - 1].gPos + seeds[i - 1].gLen)
        if abs(g2 - g1) < min_intron:
            continue
        key = (g1, g2)
        if key in sj_map:
            sj_map[key][1] += 1
        else:
            sj_map[key] = [can.SJtype, 1]


def merge_sj_maps(global_map: dict, local_map: dict) -> None:
    for key, (sj_type, count) in local_map.items():
        if key in global_map:
            global_map[key][1] += count
        else:
            global_map[key] = [sj_type, count]


def write_sj_table(idx: Index, sj_map: dict, path: str) -> int:
    """OutputSpliceJunctions (Mapping.cpp:697-716)."""
    n = 0
    with open(path, "w") as f:
        for (g1, g2) in sorted(sj_map):
            count = sj_map[(g1, g2)][1]
            k = idx.chr_lower_bound(g1)
            if k >= idx.chr_end_keys.shape[0]:
                continue
            ci = int(idx.chr_end_idx[k])
            fwd = idx.chromosomes[ci].forward_location
            f.write(f"{idx.chromosomes[ci].name}\t{g1 + 1 - fwd}\t{g2 + 1 - fwd}\t{count}\n")
            n += 1
    return n
