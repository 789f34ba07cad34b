"""Sequence-pair -> CIGAR processing (reference: tools.cpp).

All functions operate on raw byte strings: read fragments keep their
original characters (case- and N-sensitive comparisons, matching
CalFragPairMismatchBases which compares chars, tools.cpp:40-47), genome
fragments are upper-case ACGT from the expanded reference sequence.
"""

from __future__ import annotations

from ..ops.nw_numpy import nw_align
from .structs import SeedPair

GAP = ord("-")


def cal_mismatches(frag1: bytes, frag2: bytes) -> int:
    return sum(1 for a, b in zip(frag1, frag2) if a != b)


def add_new_cigar_elements(aln1: bytes, aln2: bytes, cigar: list) -> int:
    """Walk two gapped strings emitting M/I/D runs; returns the number
    of identical aligned columns (tools.cpp:49-104)."""
    state = "*"
    c = 0
    score = 0
    for a, b in zip(aln1, aln2):
        if a == GAP:
            op = "D"
        elif b == GAP:
            op = "I"
        else:
            if a == b:
                score += 1
            op = "M"
        if op == state:
            c += 1
        else:
            if c > 0:
                cigar.append((c, state))
            c = 1
            state = op
    if c > 0:
        cigar.append((c, state))
    return score


def check_local_alignment_quality(aln1: bytes, aln2: bytes) -> bool:
    """Head/tail quality gate (tools.cpp:166-201): >= 4 state switches,
    or >= 3 mismatches covering >= 30% of matched columns -> reject."""
    aln_type = -1
    n = mis = status = 0
    for a, b in zip(aln1, aln2):
        if a == GAP:
            t = 0
        elif b == GAP:
            t = 1
        else:
            n += 1
            if a != b:
                mis += 1
            t = 2
        if t != aln_type:
            aln_type = t
            status += 1
    return not (status >= 4 or (mis >= 3 and mis >= int(n * 0.3)))


def process_normal_pair(seq: bytes, ref: "np.ndarray", sp: SeedPair, cigar: list) -> int:
    """tools.cpp:130-164."""
    if sp.PosDiff == -1:
        cigar.append((sp.rLen, "S"))
        return 0
    if sp.rLen == 0 or sp.gLen == 0:
        if sp.rLen > 0:
            cigar.append((sp.rLen, "I"))
        elif sp.gLen > 0:
            cigar.append((sp.gLen, "D"))
        return 0
    frag1 = seq[sp.rPos : sp.rPos + sp.rLen]
    frag2 = ref[sp.gPos : sp.gPos + sp.gLen].tobytes()
    if sp.rLen == sp.gLen:
        n = cal_mismatches(frag1, frag2)
        if n <= 2 and n <= int(sp.rLen * 0.2):
            cigar.append((sp.rLen, "M"))
            return sp.rLen - n
    a1, a2 = nw_align(frag1, frag2)
    return add_new_cigar_elements(a1, a2, cigar)


def process_head_pair(seq: bytes, ref, sp: SeedPair, cigar: list) -> int:
    """tools.cpp:203-249. May shrink sp in place (soft-clip trimming)."""
    frag1 = seq[sp.rPos : sp.rPos + sp.rLen]
    frag2 = ref[sp.gPos : sp.gPos + sp.gLen].tobytes()
    if sp.rLen == sp.gLen:
        n = cal_mismatches(frag1, frag2)
        if n <= 2 and n <= int(sp.rLen * 0.2):
            cigar.append((sp.rLen, "M"))
            return sp.rLen - n
    a1, a2 = nw_align(frag1, frag2)
    if not check_local_alignment_quality(a1, a2):
        cigar.append((sp.rLen, "S"))
        return 0
    # Case 1: leading gaps in the read block -> shrink the genome block
    p = 0
    while p < len(a1) and a1[p] == GAP:
        p += 1
    if p > 0:
        a1 = a1[p:]
        a2 = a2[p:]
        sp.gPos += p
        sp.gLen -= p
    # Case 2: leading gaps in the genome block -> shrink the read block
    p = 0
    while p < len(a2) and a2[p] == GAP:
        p += 1
    if p > 0:
        a1 = a1[p:]
        a2 = a2[p:]
        sp.rPos += p
        sp.rLen -= p
        cigar.append((p, "S"))
    return add_new_cigar_elements(a1, a2, cigar)


def process_tail_pair(seq: bytes, ref, sp: SeedPair, cigar: list) -> int:
    """tools.cpp:251-300."""
    frag1 = seq[sp.rPos : sp.rPos + sp.rLen]
    frag2 = ref[sp.gPos : sp.gPos + sp.gLen].tobytes()
    if sp.rLen == sp.gLen:
        n = cal_mismatches(frag1, frag2)
        if n <= 2 and n <= int(sp.rLen * 0.2):
            cigar.append((sp.rLen, "M"))
            return sp.rLen - n
    a1, a2 = nw_align(frag1, frag2)
    if not check_local_alignment_quality(a1, a2):
        cigar.append((sp.rLen, "S"))
        return 0
    # Case 1: trailing gaps in the read block -> shrink the genome block
    c = 0
    p = len(a1) - 1
    while p >= 0 and a1[p] == GAP:
        c += 1
        p -= 1
    if c > 0:
        a1 = a1[: len(a1) - c]
        a2 = a2[: len(a2) - c]
        sp.gLen -= c
    # Case 2: trailing gaps in the genome block -> shrink the read block
    c = 0
    p = len(a2) - 1
    while p >= 0 and a2[p] == GAP:
        c += 1
        p -= 1
    if c > 0:
        a1 = a1[: len(a1) - c]
        a2 = a2[: len(a2) - c]
        sp.rLen -= c
    score = add_new_cigar_elements(a1, a2, cigar)
    if c > 0:
        cigar.append((c, "S"))
    return score


def generate_cigar_string(cigar: list) -> str:
    """Run-length merge of adjacent same-op entries
    (AlignmentCandidates.cpp:37-61)."""
    out = []
    state = ""
    c = 0
    for num, op in cigar:
        if op != state:
            if c > 0:
                out.append(f"{c}{state}")
            c = num
            state = op
        else:
            c += num
    if c > 0:
        out.append(f"{c}{state}")
    return "".join(out)


def check_min_intron_size(cigar: list, min_intron: int) -> bool:
    """AlignmentCandidates.cpp:1052-1064."""
    return not any(op == "N" and num < min_intron for num, op in cigar)
