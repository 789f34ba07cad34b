"""8-mer exact matching between a read fragment and a genomic window
(reference: KmerAnalysis.cpp). Used for gap re-seeding when BWT
re-seeding is not applicable (ReseedingWithSpecificRegion,
AlignmentCandidates.cpp:596-624).
"""

from __future__ import annotations

from ..constants import KMER_POWER, KMER_SIZE, NT4_TABLE
from .structs import SeedPair


def create_kmer_vec(seq: bytes) -> list[tuple[int, int]]:
    """Rolling 8-mer ids over non-'N' stretches; returns [(wid, pos)]
    sorted by wid (KmerAnalysis.cpp:34-80). Note: the reference checks
    the character 'N' specifically; other ambiguity codes roll through
    the table (value 4) — replicated via the raw char check."""
    n = len(seq)
    vec: list[tuple[int, int]] = []
    tail = 0
    count = 0
    while count < KMER_SIZE and tail < n:
        if seq[tail] != ord("N"):
            count += 1
        else:
            count = 0
        tail += 1
    if count == KMER_SIZE:
        head = tail - KMER_SIZE
        wid = 0
        for i in range(head, head + KMER_SIZE):
            wid = (wid << 2) + int(NT4_TABLE[seq[i]])
        vec.append((wid, head))
        head += 1
        while tail < n:
            if seq[tail] != ord("N"):
                wid = ((wid & KMER_POWER) << 2) + int(NT4_TABLE[seq[tail]])
                vec.append((wid, head))
                head += 1
                tail += 1
            else:
                count = 0
                tail += 1
                while count < KMER_SIZE and tail < n:
                    if seq[tail] != ord("N"):
                        count += 1
                    else:
                        count = 0
                    tail += 1
                if count == KMER_SIZE:
                    head = tail - KMER_SIZE
                    wid = 0
                    for i in range(head, head + KMER_SIZE):
                        wid = (wid << 2) + int(NT4_TABLE[seq[i]])
                    vec.append((wid, head))
                    head += 1
                else:
                    break
        vec.sort(key=lambda t: t[0])
    return vec


def identify_common_kmers(vec1, vec2) -> list[tuple[int, int, int]]:
    """Join on kmer id; returns [(pos_diff, r_pos, g_pos)] sorted by
    (pos_diff, r_pos) (KmerAnalysis.cpp:82-106)."""
    import bisect

    wids2 = [w for w, _ in vec2]
    pairs = []
    for wid, rpos in vec1:
        k = bisect.bisect_left(wids2, wid)
        while k < len(vec2) and vec2[k][0] == wid:
            gpos = vec2[k][1]
            pairs.append((gpos - rpos, rpos, gpos))
            k += 1
    pairs.sort(key=lambda t: (t[0], t[1]))
    return pairs


def longest_simple_pair_from_fragments(frag1: bytes, frag2: bytes) -> SeedPair:
    """Longest same-diagonal kmer run with >50% kmer support
    (KmerAnalysis.cpp:134-166), including the reference's support
    counter carry-over across runs (s reset only on acceptance)."""
    vec1 = create_kmer_vec(frag1)
    vec2 = create_kmer_vec(frag2)
    pairs = identify_common_kmers(vec1, vec2)
    seed = SeedPair(bSimple=True, bAcceptorSite=False)
    num = len(pairs)
    max_len = 0
    s = 1
    i = 0
    while i < num:
        pos_diff = pairs[i][0]
        j = i + 1
        while j < num and pairs[j][0] == pos_diff:
            s += 1
            j += 1
        length = KMER_SIZE + (pairs[j - 1][1] - pairs[i][1])
        if length > max_len and s > (length - KMER_SIZE) // 2:
            seed.rPos = pairs[i][1]
            seed.gPos = pairs[i][2]
            seed.rLen = seed.gLen = length
            max_len = length
            s = 1
        i = j
    return seed
