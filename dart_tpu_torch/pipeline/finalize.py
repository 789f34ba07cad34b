"""Candidate finalization: the divide-and-conquer core
(reference: AlignmentCandidates.cpp — GenMappingReport :1079 and the
stages it drives). Per candidate: prune tandem-repeat/translocated
seeds, re-seed long gaps by k-mer matching, split intron-spanning gaps
with two gapped extensions, snap splice-junction boundaries to donor/
acceptor motifs, fill remaining gaps with normal pairs, then walk the
seed chain emitting CIGAR + score.

Each step documents its reference provenance (file:line) so parity can
be audited; the implementation is independent.
"""

from __future__ import annotations

import numpy as np

from ..constants import SHIFT_ARR, SPLICE_JUNCTIONS
from ..index.loader import Index
from ..ops.nw_numpy import nw_align
from .cigar import (
    check_min_intron_size,
    generate_cigar_string,
    process_head_pair,
    process_normal_pair,
    process_tail_pair,
)
from .kmer import longest_simple_pair_from_fragments
from .structs import AlignmentCandidate, AlignmentReport, Coordinate, SeedPair, sort_by_genome_pos

INT32 = lambda x: int(np.int32(np.int64(x) & 0xFFFFFFFF))  # C int cast semantics


def _int_cast(x: int) -> int:
    """(int) cast of an int64 difference, with wraparound."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def remove_null_seeds(seeds: list[SeedPair]) -> None:
    seeds[:] = [s for s in seeds if s.rLen != 0]


def remove_tandem_repeat_seeds(seeds: list[SeedPair]) -> None:
    """Zero every seed whose rPos repeats (AlignmentCandidates.cpp:817-842)."""
    num = len(seeds)
    if num < 2:
        return
    counts: dict[int, int] = {}
    for s in seeds:
        counts[s.rPos] = counts.get(s.rPos, 0) + 1
    tandem = False
    for s in seeds:
        if counts[s.rPos] > 1:
            s.rLen = s.gLen = 0
            tandem = True
    if tandem:
        remove_null_seeds(seeds)


def remove_translocated_seeds(seeds: list[SeedPair]) -> None:
    """Drop the lighter side of read-order violations
    (AlignmentCandidates.cpp:855-902)."""
    num = len(seeds)
    if num < 2:
        return
    vec = sorted([(s.rPos, i) for i, s in enumerate(seeds)], key=lambda t: t[0])
    translocation = False
    i = 0
    while i < num:
        if vec[i][0] != seeds[i].rPos:
            translocation = True
            # IdentifyTranslocationRange (:844-853)
            max_idx = vec[i][1]
            j = i + 1
            while j <= max_idx:
                if vec[j][1] > max_idx:
                    max_idx = vec[j][1]
                j += 1
            j = max_idx
            s1 = s2 = 0
            for k in range(i, j + 1):
                if k < vec[k][1]:
                    s1 += seeds[vec[k][1]].rLen
                else:
                    s2 += seeds[vec[k][1]].rLen
            if s1 > s2:
                for k in range(i, j + 1):
                    if k > vec[k][1]:
                        seeds[vec[k][1]].rLen = seeds[vec[k][1]].gLen = 0
            else:
                for k in range(i, j + 1):
                    if k < vec[k][1]:
                        seeds[vec[k][1]].rLen = seeds[vec[k][1]].gLen = 0
            i = j
        i += 1
    if translocation:
        remove_null_seeds(seeds)


def reseed_specific_region(idx: Index, seq: bytes, r_begin: int, r_end: int,
                           l_boundary: int, r_boundary: int) -> SeedPair:
    """k-mer re-seeding of a read gap against the genomic span between
    two chained seeds (AlignmentCandidates.cpp:596-624)."""
    rlen = r_end - r_begin
    glen = r_boundary - l_boundary
    frag1 = seq[r_begin:r_end]
    frag2 = idx.ref_ascii[l_boundary:r_boundary].tobytes()
    thr = int(rlen * 0.85)
    if thr < 8:
        thr = 8
    seed = longest_simple_pair_from_fragments(frag1, frag2)
    if seed.rLen >= thr:
        seed.rPos += r_begin
        seed.gPos += l_boundary
        seed.PosDiff = seed.gPos - seed.rPos
    else:
        seed.rLen = 0
    return seed


def identify_missing_seeds(idx: Index, rlen: int, seq: bytes, seeds: list[SeedPair]) -> None:
    """AlignmentCandidates.cpp:685-700."""
    num = len(seeds)
    added = False
    for i in range(1, num):
        pos_diff = _int_cast(seeds[i].PosDiff - seeds[i - 1].PosDiff)
        r_gaps = seeds[i].rPos - seeds[i - 1].rPos - seeds[i - 1].rLen
        if pos_diff > 5 and r_gaps > 20:  # MaxGaps = 5
            seed = reseed_specific_region(
                idx, seq,
                seeds[i - 1].rPos + seeds[i - 1].rLen, seeds[i].rPos,
                seeds[i - 1].gPos + seeds[i - 1].gLen, seeds[i].gPos,
            )
            if seed.rLen > 0:
                seeds.append(seed)
                added = True
    if added:
        sort_by_genome_pos(seeds)


def identify_best_gapped_partition(idx: Index, seq: bytes, r_gaps: int,
                                   left: SeedPair, right: SeedPair, max_mismatch: int):
    """Two NW extensions across an intron gap; pick the read split point
    maximizing total matches (AlignmentCandidates.cpp:385-467).
    Returns (p, left_ext, right_ext)."""
    ref = idx.ref_ascii
    r0 = left.rPos + left.rLen
    frag1 = seq[r0 : r0 + r_gaps]
    frag2 = ref[left.gPos + left.gLen : left.gPos + left.gLen + r_gaps].tobytes()
    a1, a2 = nw_align(frag1, frag2)
    a2 = bytearray(a2)
    # replace tailing genome gaps with the genome continuation (:399-400)
    L = len(a1)
    i = L - 1
    while i >= 0 and a2[i] == ord("-"):
        i -= 1
    g = left.gPos + left.gLen + r_gaps
    for k in range(i + 1, L):
        a2[k] = ref[g]
        g += 1
    rvec = [0] * (r_gaps + 1)
    p = s = 0
    for k in range(L):
        if a1[k] == a2[k]:
            s += 1
        if a1[k] != ord("-"):
            p += 1
        rvec[p] = s

    frag3 = seq[r0 : r0 + r_gaps]
    frag4 = ref[right.gPos - r_gaps : right.gPos].tobytes()
    a3, a4 = nw_align(frag3, frag4)
    a4 = bytearray(a4)
    # replace heading genome gaps walking backwards (:424-425)
    i = 0
    while i < len(a4) and a4[i] == ord("-"):
        i += 1
    g = right.gPos - r_gaps
    for k in range(i - 1, -1, -1):
        a4[k] = ref[g]
        g -= 1
    L3 = len(a3)
    lvec = [0] * (r_gaps + 1)
    p = s = 0
    for k in range(L3 - 1, -1, -1):
        if a3[k] == a4[k]:
            s += 1
        if a3[k] != ord("-"):
            p += 1
        lvec[r_gaps - p] = s

    max_score = 0
    best_p = 0
    for k in range(r_gaps + 1):
        sc = rvec[k] + lvec[k]
        if sc > max_score:
            max_score = sc
            best_p = k
    if max_score < int(r_gaps * 0.8) or (r_gaps - max_score) > max_mismatch:
        return best_p, 0, 0
    right_ext = 0
    p = best_p
    k = 0
    while p > 0:
        if a1[k] != ord("-"):
            p -= 1
        if a2[k] != ord("-"):
            right_ext += 1
        k += 1
    left_ext = 0
    p = r_gaps - best_p
    k = len(a3) - 1
    while p > 0:
        if a3[k] != ord("-"):
            p -= 1
        if a4[k] != ord("-"):
            left_ext += 1
        k -= 1
    return best_p, left_ext, right_ext


def fill_gaps_between_adjacent_seeds(idx: Index, seq: bytes, left: SeedPair,
                                     right: SeedPair, out: list[SeedPair],
                                     max_mismatch: int) -> None:
    """AlignmentCandidates.cpp:547-575."""
    r_gaps = right.rPos - (left.rPos + left.rLen)
    p, left_ext, right_ext = identify_best_gapped_partition(
        idx, seq, r_gaps, left, right, max_mismatch)
    if p > 0:
        s = SeedPair(bSimple=False, bAcceptorSite=False)
        s.rPos = left.rPos + left.rLen
        s.gPos = left.gPos + left.gLen
        s.rLen = p
        s.gLen = right_ext
        s.PosDiff = s.gPos - s.rPos
        out.append(s)
    rem = r_gaps - p
    if rem > 0:
        s = SeedPair(bSimple=False, bAcceptorSite=False)
        s.rLen = rem
        s.gLen = left_ext
        s.rPos = right.rPos - s.rLen
        s.gPos = right.gPos - s.gLen
        s.PosDiff = s.gPos - s.rPos
        out.append(s)


def seed_extension(idx: Index, seq: bytes, seeds: list[SeedPair],
                   min_intron: int, max_mismatch: int) -> None:
    """AlignmentCandidates.cpp:577-594."""
    added: list[SeedPair] = []
    num = len(seeds)
    for i in range(1, num):
        pos_diff = _int_cast(seeds[i].PosDiff - seeds[i - 1].PosDiff)
        if pos_diff > min_intron and seeds[i].rPos > (seeds[i - 1].rPos + seeds[i - 1].rLen):
            fill_gaps_between_adjacent_seeds(idx, seq, seeds[i - 1], seeds[i], added, max_mismatch)
    if added:
        seeds.extend(added)
        sort_by_genome_pos(seeds)


def _check_seq_fragment(ref, left_g: int, right_g: int, shift: int) -> bool:
    """AlignmentCandidates.cpp:702-730: shifted bases must be identical
    across the junction."""
    if shift > 0:
        a = ref[left_g : left_g + shift]
        b = ref[right_g : right_g + shift]
    else:
        sh = -shift
        a = ref[left_g - sh : left_g]
        b = ref[right_g - sh : right_g]
    return bool((a == b).all())


def identify_splice_junction(idx: Index, sj_type: int, left: SeedPair, right: SeedPair) -> int:
    """Try boundary shifts for one motif type; returns the shift or 10
    (AlignmentCandidates.cpp:732-756)."""
    ref = idx.ref_ascii
    motif = SPLICE_JUNCTIONS[sj_type]
    m0, m1, m3, m4 = (ord(motif[0]), ord(motif[1]), ord(motif[3]), ord(motif[4]))
    i = min(left.rLen, right.rLen)
    j = min(left.gLen, right.gLen)
    if i < j:
        j = i
    if j > 9:
        j = 9
    j <<= 1
    left_g = left.gPos + left.gLen
    right_g = right.gPos
    shift = 0
    k = 0
    while k <= j:
        shift = SHIFT_ARR[k]
        if shift == 0 or _check_seq_fragment(ref, left_g, right_g, shift):
            g1 = left_g + shift
            g2 = right_g - 2 + shift
            if ref[g1] == m0 and ref[g1 + 1] == m1 and ref[g2] == m3 and ref[g2 + 1] == m4:
                break
        k += 1
    if k > j:
        return 10
    return shift


def check_splice_junction(idx: Index, seeds: list[SeedPair], min_intron: int) -> int:
    """Pick the motif type minimizing total boundary shift and snap seed
    boundaries (AlignmentCandidates.cpp:758-815). Returns SJ type or -1."""
    num = len(seeds)
    min_cost = 1000
    best_type = -1
    best_vec: list[tuple[int, int]] = []
    for sj_type in range(4):
        vec: list[tuple[int, int]] = []
        mis = 0
        c = 0
        for i in range(1, num):
            if (seeds[i].PosDiff - seeds[i - 1].PosDiff) > min_intron \
                    and seeds[i - 1].bSimple and seeds[i].bSimple:
                shift = identify_splice_junction(idx, sj_type, seeds[i - 1], seeds[i])
                if shift != 10:
                    vec.append((i, shift))
                else:
                    mis += 1
                c += abs(shift)
        if vec and c < min_cost:
            min_cost = c
            best_type = sj_type
            best_vec = vec
        if mis == 0:
            break
    if best_type != -1:
        for i, shift in best_vec:
            seeds[i].bAcceptorSite = True
            if shift != 0:
                seeds[i - 1].rLen += shift
                seeds[i - 1].gLen += shift
                seeds[i].rLen -= shift
                seeds[i].gLen -= shift
                seeds[i].rPos += shift
                seeds[i].gPos += shift
    return best_type


def check_seed_overlapping(p1: SeedPair, p2: SeedPair) -> bool:
    """AlignmentCandidates.cpp:904-954. Returns False when p1 lost."""
    master = True
    overlap = p1.rPos + p1.rLen - p2.rPos
    if overlap > 0:
        if p1.rLen < p2.rLen:
            master = False
            if p1.rLen > overlap:
                p1.rLen -= overlap
                p1.gLen = p1.rLen
            else:
                p1.rLen = p1.gLen = 0
        else:
            if p2.rLen > overlap:
                p2.rPos += overlap
                p2.gPos += overlap
                p2.rLen -= overlap
                p2.gLen = p2.rLen
            else:
                p2.rLen = p2.gLen = 0
    if p1.rLen > 0 and p2.rLen > 0:
        overlap = p1.gPos + p1.gLen - p2.gPos
        if overlap > 0:
            if p1.gLen < p2.gLen:
                master = False
                if p1.rLen > overlap:
                    p1.rLen -= overlap
                    p1.gLen = p1.rLen
                else:
                    p1.rLen = p1.gLen = 0
            else:
                if p2.rLen > overlap:
                    p2.rPos += overlap
                    p2.gPos += overlap
                    p2.rLen -= overlap
                    p2.gLen = p2.rLen
                else:
                    p2.rLen = p2.gLen = 0
    return master


def check_overlapping_seeds(seeds: list[SeedPair]) -> None:
    """AlignmentCandidates.cpp:963-999."""
    num = len(seeds)
    if num < 2:
        return
    null_seed = False
    i = 0
    while i < num:
        if seeds[i].rLen > 0:
            r_end = seeds[i].rPos + seeds[i].rLen - 1
            g_end = seeds[i].gPos + seeds[i].gLen - 1
            j = i + 1
            while j < num:
                if seeds[j].rLen == 0:
                    j += 1
                    continue
                if r_end < seeds[j].rPos and g_end < seeds[j].gPos:
                    break
                if not check_seed_overlapping(seeds[i], seeds[j]):
                    break
                j += 1
            if seeds[i].rLen == 0:
                null_seed = True
                # backtrack to the previous surviving seed (:956-961)
                k = i - 1
                while k > 0 and seeds[k].rLen == 0:
                    k -= 1
                i = 0 if k < 0 else k
            else:
                i += 1
        else:
            null_seed = True
            i += 1
    if null_seed:
        remove_null_seeds(seeds)


def identify_normal_pairs(seeds: list[SeedPair]) -> None:
    """Insert gap-closing normal pairs between consecutive seeds
    (AlignmentCandidates.cpp:1001-1035)."""
    if len(seeds) <= 1:
        return
    check_overlapping_seeds(seeds)
    num = len(seeds)
    added: list[SeedPair] = []
    for i in range(num - 1):
        j = i + 1
        if seeds[j].rPos - seeds[i].rPos - seeds[i].rLen == 0:
            continue
        r_gaps = seeds[j].rPos - (seeds[i].rPos + seeds[i].rLen)
        if r_gaps < 0:
            r_gaps = 0
        g_gaps = seeds[j].gPos - (seeds[i].gPos + seeds[i].gLen)
        if g_gaps < 0:
            g_gaps = 0
        elif g_gaps > 30 and g_gaps > (r_gaps << 1):
            g_gaps = 0  # large genomic gap becomes an intron 'N'
        if r_gaps > 0 or g_gaps > 0:
            s = SeedPair(bSimple=False, bAcceptorSite=False)
            s.rPos = seeds[i].rPos + seeds[i].rLen
            s.gPos = seeds[i].gPos + seeds[i].gLen
            s.PosDiff = s.gPos - s.rPos
            s.rLen = r_gaps
            s.gLen = g_gaps
            added.append(s)
    if added:
        # std::inplace_merge with CompByGenomePos
        merged = []
        a, b = 0, 0
        key = lambda s: (s.gPos, s.rPos)
        while a < num and b < len(added):
            if key(added[b]) < key(seeds[a]):
                merged.append(added[b])
                b += 1
            else:
                merged.append(seeds[a])
                a += 1
        merged.extend(seeds[a:num])
        merged.extend(added[b:])
        seeds[:] = merged


def check_coordinate_validity(idx: Index, seeds: list[SeedPair]) -> bool:
    """Chain must not straddle the fwd/rev genome boundary
    (AlignmentCandidates.cpp:136-163)."""
    g1 = 0
    g2 = idx.seq_len
    for s in seeds:
        if s.gLen > 0:
            g1 = s.gPos
            break
    for s in reversed(seeds):
        if s.gLen > 0:
            g2 = s.gPos + s.gLen - 1
            break
    G = idx.genome_size
    return not ((g1 < G <= g2) or (g1 >= G > g2))


def gen_coordinate_info(idx: Index, b_first_read: bool, g_pos: int, end_g_pos: int) -> Coordinate:
    """Concatenated-genome position -> (chr, 1-based pos, strand)
    (AlignmentCandidates.cpp:83-116)."""
    coor = Coordinate()
    if g_pos < idx.genome_size:
        coor.bDir = bool(b_first_read)
        k = idx.chr_lower_bound(g_pos)
        coor.ChromosomeIdx = int(idx.chr_end_idx[k])
        coor.gPos = g_pos + 1 - idx.chromosomes[coor.ChromosomeIdx].forward_location
    else:
        coor.bDir = not b_first_read
        k = idx.chr_lower_bound(g_pos)
        coor.ChromosomeIdx = int(idx.chr_end_idx[k])
        coor.gPos = int(idx.chr_end_keys[k]) - end_g_pos + 1
    return coor


def gen_mapping_report(idx: Index, cfg, b_first_read: bool, read,
                       alignments: list[AlignmentCandidate]) -> None:
    """GenMappingReport (AlignmentCandidates.cpp:1079-1207)."""
    read.score = 0
    read.best_idx = 0
    read.sub_score = 0
    read.mis_num = 0
    read.can_num = len(alignments)
    if read.can_num > 0:
        read.reports = [AlignmentReport() for _ in range(read.can_num)]
        for i, can in enumerate(alignments):
            rep = read.reports[i]
            rep.SJtype = -1
            rep.AlnScore = 0
            rep.PairedAlnCanIdx = can.PairedAlnCanIdx
            if can.Score == 0:
                continue
            seeds = can.SeedVec
            remove_tandem_repeat_seeds(seeds)
            remove_translocated_seeds(seeds)
            identify_missing_seeds(idx, read.rlen, read.seq, seeds)
            seed_extension(idx, read.seq, seeds, cfg.min_intron_size, cfg.max_mismatch)
            rep.SJtype = can.SJtype = check_splice_junction(idx, seeds, cfg.min_intron_size)
            identify_normal_pairs(seeds)

            num = len(seeds)
            if num > 1 and not check_coordinate_validity(idx, seeds):
                continue
            cigar: list[tuple[int, str]] = []
            mis_num = 0
            for j in range(num):
                sp = seeds[j]
                if sp.rLen == 0 and sp.gLen == 0:
                    continue
                if j > 0:
                    g = sp.gPos - (seeds[j - 1].gPos + seeds[j - 1].gLen)
                    if g > 0:
                        cigar.append((g, "N"))
                if sp.bSimple:
                    cigar.append((sp.rLen, "M"))
                    rep.AlnScore += sp.rLen
                else:
                    if j == 0:
                        score = process_head_pair(read.seq, idx.ref_ascii, sp, cigar)
                    elif j == num - 1:
                        score = process_tail_pair(read.seq, idx.ref_ascii, sp, cigar)
                    else:
                        score = process_normal_pair(read.seq, idx.ref_ascii, sp, cigar)
                    rep.AlnScore += score
                    mis_num += sp.rLen - score
            if num > 0:
                j = seeds[0].rPos
                if j > 0:
                    cigar.insert(0, (j, "S"))
                j = read.rlen - (seeds[-1].rPos + seeds[-1].rLen)
                if j > 0:
                    cigar.append((j, "S"))
            if mis_num > cfg.max_mismatch or len(cigar) == 0:
                rep.AlnScore = 0
            if not check_min_intron_size(cigar, cfg.min_intron_size):
                rep.AlnScore = 0
            if rep.AlnScore > 0:
                rep.coor = gen_coordinate_info(
                    idx, b_first_read, seeds[0].gPos,
                    seeds[-1].gPos + seeds[-1].gLen - 1)
                if rep.coor.gPos <= 0:
                    rep.AlnScore = 0
                else:
                    if seeds[0].gPos >= idx.genome_size:
                        cigar.reverse()
                    rep.coor.CIGAR = generate_cigar_string(cigar)
                if rep.AlnScore > read.score:
                    read.best_idx = i
                    read.mis_num = mis_num
                    read.sub_score = read.score
                    read.score = rep.AlnScore
                elif rep.AlnScore == read.score:
                    read.sub_score = read.score
    else:
        read.can_num = 1
        read.best_idx = 0
        rep = AlignmentReport()
        rep.AlnScore = 0
        rep.PairedAlnCanIdx = -1
        read.reports = [rep]
