"""SAM flags, MAPQ, and record formatting
(reference: Mapping.cpp:74-369)."""

from __future__ import annotations

from ..io.fastx import revcomp_bytes

MAX_MAPQ = 50
XS_A_STR = ["", " XS:A:+", " XS:A:-"]


def set_single_alignment_flag(read) -> None:
    """Mapping.cpp:74-99."""
    if read.score > read.sub_score:
        rep = read.reports[read.best_idx]
        rep.iFrag = 0x10 if not rep.coor.bDir else 0
    elif read.score > 0:
        for rep in read.reports:
            if rep.AlnScore > 0:
                rep.iFrag = 0x10 if not rep.coor.bDir else 0
    else:
        read.reports[0].iFrag = 0x4


def set_paired_alignment_flag(read1, read2) -> None:
    """Mapping.cpp:101-186."""
    if read1.score > read1.sub_score and read2.score > read2.sub_score:
        i = read1.best_idx
        rep1 = read1.reports[i]
        rep1.iFrag = 0x41
        j = read2.best_idx
        rep2 = read2.reports[j]
        rep2.iFrag = 0x81
        if j == rep1.PairedAlnCanIdx:
            rep1.iFrag |= 0x2
            rep2.iFrag |= 0x2
        rep1.iFrag |= 0x20 if rep1.coor.bDir else 0x10
        rep2.iFrag |= 0x20 if rep2.coor.bDir else 0x10
        return

    if read1.score > read1.sub_score:
        i = read1.best_idx
        rep = read1.reports[i]
        rep.iFrag = 0x41
        rep.iFrag |= 0x20 if rep.coor.bDir else 0x10
        j = rep.PairedAlnCanIdx
        if j != -1 and read2.reports[j].AlnScore > 0:
            rep.iFrag |= 0x2
        else:
            rep.iFrag |= 0x8
    elif read1.score > 0:
        for rep in read1.reports:
            if rep.AlnScore > 0:
                rep.iFrag = 0x41
                rep.iFrag |= 0x20 if rep.coor.bDir else 0x10
                j = rep.PairedAlnCanIdx
                if j != -1 and read2.reports[j].AlnScore > 0:
                    rep.iFrag |= 0x2
                else:
                    rep.iFrag |= 0x8
    else:
        rep = read1.reports[0]
        rep.iFrag = 0x41 | 0x4
        if read2.score == 0:
            rep.iFrag |= 0x8
        else:
            rep.iFrag |= 0x10 if read2.reports[read2.best_idx].coor.bDir else 0x20

    if read2.score > read2.sub_score:
        j = read2.best_idx
        rep = read2.reports[j]
        rep.iFrag = 0x81
        rep.iFrag |= 0x20 if rep.coor.bDir else 0x10
        i = rep.PairedAlnCanIdx
        if i != -1 and read1.reports[i].AlnScore > 0:
            rep.iFrag |= 0x2
        else:
            rep.iFrag |= 0x8
    elif read2.score > 0:
        for rep in read2.reports:
            if rep.AlnScore > 0:
                rep.iFrag = 0x81
                rep.iFrag |= 0x20 if rep.coor.bDir else 0x10
                i = rep.PairedAlnCanIdx
                if i != -1 and read1.reports[i].AlnScore > 0:
                    rep.iFrag |= 0x2
                else:
                    rep.iFrag |= 0x8
    else:
        rep = read2.reports[0]
        rep.iFrag = 0x81 | 0x4
        if read1.score == 0:
            rep.iFrag |= 0x8
        else:
            rep.iFrag |= 0x10 if read1.reports[read1.best_idx].coor.bDir else 0x20


def evaluate_mapq(read) -> None:
    """Mapping.cpp:188-206."""
    if read.score == 0 or read.score == read.sub_score:
        read.mapq = 0
        return
    if read.sub_score == 0 or read.score > read.sub_score:
        read.mapq = MAX_MAPQ
    else:
        # score < sub_score can happen after paired reconciliation
        n = sum(1 for rep in read.reports if rep.AlnScore == read.score)
        if n >= 10:
            read.mapq = 0
        elif n >= 4:
            read.mapq = 1
        elif n == 3:
            read.mapq = 2
        elif n == 2:
            read.mapq = 3
        else:
            read.mapq = MAX_MAPQ


def _xs_idx(sj_type: int, first_read: bool) -> int:
    if sj_type == -1:
        return 0
    plus = sj_type in (0, 2)
    if not first_read:
        plus = not plus
    return 1 if plus else 2


def _qual_str(read, fastq: bool, rev: bool) -> str:
    if not fastq:
        return "*"
    q = read.qual or b""
    return (q[::-1] if rev else q).decode("latin-1")


def output_single(cfg, chromosomes, read, fastq: bool, counters, out: list) -> None:
    """OutputSingledAlignments (Mapping.cpp:317-369)."""
    if read.score == 0:
        counters["unmapped"] += 1
        out.append(
            f"{read.header}\t{read.reports[0].iFrag}\t*\t0\t0\t*\t*\t0\t0\t"
            f"{read.seq.decode('latin-1')}\t{_qual_str(read, fastq, False)}\tAS:i:0\tXS:i:0"
        )
        return
    if cfg.unique_only and read.mapq <= 3:
        return
    if read.mapq == MAX_MAPQ:
        counters["unique"] += 1
    seq = read.seq.decode("latin-1")
    rseq = None
    for i in range(read.best_idx, read.can_num):
        rep = read.reports[i]
        if rep.AlnScore == read.score:
            if not rep.coor.bDir and rseq is None:
                rseq = revcomp_bytes(read.seq).decode("latin-1")
            out.append(
                f"{read.header}\t{rep.iFrag}\t{chromosomes[rep.coor.ChromosomeIdx].name}\t"
                f"{rep.coor.gPos}\t{read.mapq}\t{rep.coor.CIGAR}\t*\t0\t0\t"
                f"{seq if rep.coor.bDir else rseq}\t{_qual_str(read, fastq, not rep.coor.bDir)}\t"
                f"NM:i:{read.mis_num}\tAS:i:{read.score}\tXS:i:{read.sub_score}"
                f"{XS_A_STR[_xs_idx(rep.SJtype, True)]}"
            )
            if not cfg.multi_hit:
                break


def output_paired(cfg, chromosomes, read1, read2, fastq: bool, counters, out: list) -> None:
    """OutputPairedAlignments (Mapping.cpp:208-315)."""
    # read 1
    if read1.score == 0:
        counters["unmapped"] += 1
        out.append(
            f"{read1.header}\t{read1.reports[0].iFrag}\t*\t0\t0\t*\t*\t0\t0\t"
            f"{read1.seq.decode('latin-1')}\t{_qual_str(read1, fastq, False)}\tAS:i:0\tXS:i:0"
        )
    elif not cfg.unique_only or read1.mapq > 3:
        if read1.mapq == MAX_MAPQ:
            counters["unique"] += 1
        seq = read1.seq.decode("latin-1")
        rseq = None
        for i in range(read1.best_idx, read1.can_num):
            rep = read1.reports[i]
            if rep.AlnScore > 0:
                if not rep.coor.bDir and rseq is None:
                    rseq = revcomp_bytes(read1.seq).decode("latin-1")
                j = rep.PairedAlnCanIdx
                if j != -1 and read2.reports[j].AlnScore > 0:
                    dist = (read2.reports[j].coor.gPos - rep.coor.gPos
                            + (read2.rlen if rep.coor.bDir else -read1.rlen))
                    if i == read1.best_idx:
                        counters["paired"] += 2
                    out.append(
                        f"{read1.header}\t{rep.iFrag}\t{chromosomes[rep.coor.ChromosomeIdx].name}\t"
                        f"{rep.coor.gPos}\t{read1.mapq}\t{rep.coor.CIGAR}\t=\t"
                        f"{read2.reports[j].coor.gPos}\t{dist}\t"
                        f"{seq if rep.coor.bDir else rseq}\t{_qual_str(read1, fastq, not rep.coor.bDir)}\t"
                        f"NM:i:{read1.mis_num}\tAS:i:{read1.score}\tXS:i:{read1.sub_score}"
                        f"{XS_A_STR[_xs_idx(rep.SJtype, True)]}"
                    )
                else:
                    out.append(
                        f"{read1.header}\t{rep.iFrag}\t{chromosomes[rep.coor.ChromosomeIdx].name}\t"
                        f"{rep.coor.gPos}\t{read1.mapq}\t{rep.coor.CIGAR}\t*\t0\t0\t"
                        f"{seq if rep.coor.bDir else rseq}\t{_qual_str(read1, fastq, not rep.coor.bDir)}\t"
                        f"NM:i:{read1.mis_num}\tAS:i:{read1.score}\tXS:i:{read1.sub_score}"
                        f"{XS_A_STR[_xs_idx(rep.SJtype, True)]}"
                    )
            if not cfg.multi_hit:
                break

    # read 2 (its seq was reverse-complemented at load: bDir semantics invert)
    if read2.score == 0:
        counters["unmapped"] += 1
        out.append(
            f"{read2.header}\t{read2.reports[0].iFrag}\t*\t0\t0\t*\t*\t0\t0\t"
            f"{read2.seq.decode('latin-1')}\t{_qual_str(read2, fastq, False)}\tAS:i:0\tXS:i:0"
        )
    elif not cfg.unique_only or read2.mapq > 3:
        if read2.mapq == MAX_MAPQ:
            counters["unique"] += 1
        rseq = read2.seq.decode("latin-1")
        seq = None
        for j in range(read2.best_idx, read2.can_num):
            rep = read2.reports[j]
            if rep.AlnScore > 0:
                if rep.coor.bDir and seq is None:
                    seq = revcomp_bytes(read2.seq).decode("latin-1")
                i = rep.PairedAlnCanIdx
                if i != -1 and read1.reports[i].AlnScore > 0:
                    dist = -(read2.reports[j].coor.gPos - read1.reports[i].coor.gPos
                             + (read2.rlen if read1.reports[i].coor.bDir else -read1.rlen))
                    out.append(
                        f"{read2.header}\t{rep.iFrag}\t{chromosomes[rep.coor.ChromosomeIdx].name}\t"
                        f"{rep.coor.gPos}\t{read2.mapq}\t{rep.coor.CIGAR}\t=\t"
                        f"{read1.reports[i].coor.gPos}\t{dist}\t"
                        f"{seq if rep.coor.bDir else rseq}\t{_qual_str(read2, fastq, rep.coor.bDir)}\t"
                        f"NM:i:{read2.mis_num}\tAS:i:{read2.score}\tXS:i:{read2.sub_score}"
                        f"{XS_A_STR[_xs_idx(rep.SJtype, False)]}"
                    )
                else:
                    out.append(
                        f"{read2.header}\t{rep.iFrag}\t{chromosomes[rep.coor.ChromosomeIdx].name}\t"
                        f"{rep.coor.gPos}\t{read2.mapq}\t{rep.coor.CIGAR}\t*\t0\t0\t"
                        f"{seq if rep.coor.bDir else rseq}\t{_qual_str(read2, fastq, rep.coor.bDir)}\t"
                        f"NM:i:{read2.mis_num}\tAS:i:{read2.score}\tXS:i:{read2.sub_score}"
                        f"{XS_A_STR[_xs_idx(rep.SJtype, False)]}"
                    )
            if not cfg.multi_hit:
                break
