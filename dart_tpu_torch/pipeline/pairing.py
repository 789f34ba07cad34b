"""Paired-end candidate mating and final-alignment reconciliation
(reference: Mapping.cpp:371-530)."""

from __future__ import annotations

from .structs import AlignmentCandidate


def remove_redundant_candidates(alignments: list[AlignmentCandidate]) -> None:
    """Keep candidates scoring >= the 2nd-best (or only the best when the
    gap is > 20 or the top is tied) (Mapping.cpp:371-401)."""
    if len(alignments) <= 1:
        return
    score1 = score2 = 0
    for can in alignments:
        if can.Score > score2:
            if can.Score >= score1:
                score2 = score1
                score1 = can.Score
            else:
                score2 = can.Score
        elif can.Score == score2:
            score2 = score1
    thr = score1 if (score1 == score2 or score1 - score2 > 20) else score2
    for can in alignments:
        if can.Score < thr:
            can.Score = 0


def check_paired_alignment_candidates(av1: list[AlignmentCandidate],
                                      av2: list[AlignmentCandidate]) -> bool:
    """Mate candidates by diagonal distance (< 2,000,000, mate 2
    downstream) (Mapping.cpp:403-450)."""
    pairing = False
    num1, num2 = len(av1), len(av2)
    if num1 * num2 > 1000:
        remove_redundant_candidates(av1)
        remove_redundant_candidates(av2)
    for i in range(num1):
        if av1[i].Score == 0:
            continue
        best_mate = -1
        min_dist = 2000000
        for j in range(num2):
            if av2[j].Score == 0 or av2[j].PosDiff < av1[i].PosDiff:
                continue
            dist = abs(av2[j].PosDiff - av1[i].PosDiff)
            if dist < min_dist:
                best_mate = j
                min_dist = dist
        if best_mate != -1:
            j = best_mate
            if av2[j].PairedAlnCanIdx == -1:
                pairing = True
                av1[i].PairedAlnCanIdx = j
                av2[j].PairedAlnCanIdx = i
            elif av1[i].Score > av1[av2[j].PairedAlnCanIdx].Score:
                av1[av2[j].PairedAlnCanIdx].PairedAlnCanIdx = -1
                av1[i].PairedAlnCanIdx = j
                av2[j].PairedAlnCanIdx = i
    return pairing


def remove_unmated_candidates(av1: list[AlignmentCandidate],
                              av2: list[AlignmentCandidate]) -> None:
    """Zero unmated candidates; paired ones get the summed score
    (Mapping.cpp:452-477)."""
    for can in av1:
        if can.PairedAlnCanIdx == -1:
            can.Score = 0
        else:
            mate = av2[can.PairedAlnCanIdx]
            can.Score = mate.Score = can.Score + mate.Score
    for can in av2:
        if can.PairedAlnCanIdx == -1:
            can.Score = 0


def check_paired_final_alignments(cfg, read1, read2) -> None:
    """Reconcile best indices after finalization (Mapping.cpp:479-530)."""
    if read1.best_idx != -1 and read2.best_idx != -1:
        mated = read1.reports[read1.best_idx].PairedAlnCanIdx == read2.best_idx
    else:
        mated = False

    if not cfg.multi_hit and mated:
        return
    if not mated and read1.score > 0 and read2.score > 0:
        s = 0
        for i in range(read1.can_num):
            j = read1.reports[i].PairedAlnCanIdx
            if read1.reports[i].AlnScore > 0 and j != -1 and read2.reports[j].AlnScore > 0:
                mated = True
                tot = read1.reports[i].AlnScore + read2.reports[j].AlnScore
                if s < tot:
                    s = tot
                    read1.best_idx = i
                    read1.score = read1.reports[i].AlnScore
                    read2.best_idx = j
                    read2.score = read2.reports[j].AlnScore
    if mated:
        for i in range(read1.can_num):
            rep = read1.reports[i]
            j = rep.PairedAlnCanIdx
            if rep.AlnScore != read1.score or (j != -1 and read2.reports[j].AlnScore != read2.score):
                rep.AlnScore = 0
                rep.PairedAlnCanIdx = -1
    else:
        for rep in read1.reports:
            rep.PairedAlnCanIdx = -1
            if rep.AlnScore > 0 and rep.AlnScore != read1.score:
                rep.AlnScore = 0
        for rep in read2.reports:
            rep.PairedAlnCanIdx = -1
            if rep.AlnScore > 0 and rep.AlnScore != read2.score:
                rep.AlnScore = 0
