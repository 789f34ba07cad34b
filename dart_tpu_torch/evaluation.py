"""Offline accuracy evaluators, ports of the reference's Evaluation/
tools (same metrics, file-format-compatible):

- general_evaluation  (eva,     GeneralEvaluation.cpp): sensitivity and
  mean sequence identity by replaying each SAM CIGAR against the
  reference genome; at most 2 alignments per read (:119).
- flux_evaluation     (FluxEva, FluxEvaluation.cpp): accuracy on
  simulated reads whose names encode the truth region `chr:start-end`;
  an alignment is correct iff same chromosome and POS within the truth
  span; MAPQ=0 alignments are excluded from the denominator (:58).
- sj_evaluation       (SJ_Eva,  SJ_Evaluation.cpp): splice-junction
  precision vs an annotated junction list; a reported junction counts
  iff both ends are within 5 bp of an annotated one (:105).

Each returns a dict of the metrics the reference prints; the CLI
subcommands (`dart-tpu-torch eva|fluxeva|sjeva`) print the reference-style
summary lines.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass


def read_fasta(path: str) -> dict[str, str]:
    seqs: dict[str, str] = {}
    name = None
    parts: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(parts)
                name = line[1:]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


def _cigar_ops(cigar: str):
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            yield num, ch
            num = 0


def cal_seq_identity(rlen: int, chrlen: int, g_pos: int, cigar: str,
                     qseq: str, rseq: str) -> tuple[int, int]:
    """Rebuild the pairwise alignment from the CIGAR and count identical
    columns (GeneralEvaluation.cpp:30-75). Returns (identities, length)."""
    aln1: list[str] = []
    aln2: list[str] = []
    r_pos = 0
    for num, op in _cigar_ops(cigar):
        if op in "MIS" and r_pos + num > rlen:
            break
        if op in "MD" and g_pos + num > chrlen:
            break
        if op == "I":
            aln1.append(qseq[r_pos:r_pos + num])
            r_pos += num
            aln2.append("-" * num)
        elif op == "D":
            aln1.append("-" * num)
            aln2.append(rseq[g_pos:g_pos + num])
            g_pos += num
        elif op == "S":
            r_pos += num
        elif op == "N":
            g_pos += num
        elif op != "H":
            aln1.append(qseq[r_pos:r_pos + num])
            r_pos += num
            aln2.append(rseq[g_pos:g_pos + num])
            g_pos += num
    a = "".join(aln1)
    b = "".join(aln2)
    idy = sum(1 for x, y in zip(a, b) if x == y)
    return idy, len(a)


def general_evaluation(sam_path: str, ref_fasta: str,
                       progress=None) -> dict:
    """eva: sensitivity + mean sequence identity (<=2 alignments/read)."""
    refs = read_fasta(ref_fasta)
    # the reference keys RefSeqMap by the full header line
    total = aln = 0
    total_idy = 0
    prev = None
    hits = 0
    with open(sam_path) as f:
        for line in f:
            if not line or line[0] == "@":
                continue
            p = line.rstrip("\n").split("\t")
            if len(p) < 10:
                continue
            qname, chrname, cigar, qseq = p[0], p[2], p[5], p[9]
            g_pos = int(p[3])
            if prev != qname:
                hits = 1
                prev = qname
            else:
                hits += 1
                if hits > 2:
                    continue
            total += 1
            g_pos -= 1
            if cigar == "*" or g_pos < 0 or chrname not in refs:
                continue
            aln += 1
            rseq = refs[chrname]
            idy, length = cal_seq_identity(len(qseq), len(rseq), g_pos,
                                           cigar, qseq.upper(), rseq)
            if length > 0:
                total_idy += 1000 * idy // length
    sens = (aln / total + 0.0005) if total else 0.0
    avg_idy = (total_idy / aln / 1000.0 + 0.0005) if aln else 0.0
    return {"aligned": aln, "total": total, "sensitivity": sens,
            "avg_seq_identity": avg_idy}


def parse_truth_region(header: str) -> tuple[str, int, int]:
    """FluxEvaluation.cpp:10-24: truth region from `chr:start-endW...`."""
    p1 = header.find(":")
    p2 = header.find("-")
    chrom = header[:p1]
    left = int(header[p1 + 1:p2] or 0)
    tail = header[p2 + 1:]
    digits = ""
    for ch in tail:
        if ch.isdigit():
            digits += ch
        else:
            break
    right = int(digits or 0)
    return chrom, left, right


def flux_evaluation(sam_path: str) -> dict:
    """FluxEva: accuracy for truth-in-readname simulated reads."""
    total = cor = low_mapq = empty = 0
    prev = None
    hits = 0
    with open(sam_path) as f:
        for line in f:
            if not line or line[0] == "@":
                continue
            p = line.rstrip("\n").split("\t")
            if len(p) < 6:
                continue
            header, p_chr, cigar = p[0], p[2], p[5]
            g_pos = int(p[3])
            mapq = int(p[4])
            r_chr, left, right = parse_truth_region(header)
            if prev != header:
                hits = 1
                prev = header
            else:
                hits += 1
            if hits > 2:
                continue
            total += 1
            if cigar == "*":
                empty += 1
            elif mapq == 0:
                low_mapq += 1
            elif p_chr == r_chr and left <= g_pos <= right:
                cor += 1
    denom = total - empty - low_mapq
    acc = int(1000 * (cor / denom + 0.0005)) / 10.0 if denom > 0 else 0.0
    return {"correct": cor, "evaluated": denom, "accuracy_pct": acc,
            "total": total, "unaligned": empty, "mapq0": low_mapq}


@dataclass
class _SJ:
    chrom: str
    start: int
    end: int


def _read_sj(path: str) -> list[_SJ]:
    out = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 3:
                out.append(_SJ(p[0], int(p[1]), int(p[2])))
    return out


def sj_evaluation(sj_path: str, truth_path: str, tol: int = 5) -> dict:
    """SJ_Eva: reported junction correct iff both ends within `tol` bp
    of an annotated junction on the same chromosome."""
    ann = _read_sj(truth_path)
    rep = _read_sj(sj_path)
    by_chr: dict[str, list[_SJ]] = {}
    for sj in ann:
        by_chr.setdefault(sj.chrom, []).append(sj)
    annotated = 0
    for sj in rep:
        for cand in by_chr.get(sj.chrom, ()):
            if abs(sj.start - cand.start) < tol and abs(sj.end - cand.end) < tol:
                annotated += 1
                break
    acc = int(10000 * annotated / len(rep)) / 100.0 if rep else 0.0
    return {"annotated_sj": len(ann), "reported_sj": len(rep),
            "correct": annotated, "precision_pct": acc}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: dart-tpu-eval eva <out.sam> [ref.fa]\n"
              "       dart-tpu-eval fluxeva <out.sam>\n"
              "       dart-tpu-eval sjeva <junctions.tab> [junctions.txt]",
              file=sys.stderr)
        return 1
    cmd = argv[0]
    if cmd == "eva":
        ref = argv[2] if len(argv) > 2 else "hg38.fa"
        r = general_evaluation(argv[1], ref)
        print(f"sensitivity = {r['aligned']} / {r['total']} = "
              f"{r['sensitivity']:.3f}, AvgSeqIdy = {r['avg_seq_identity']:.3f}")
    elif cmd == "fluxeva":
        r = flux_evaluation(argv[1])
        print(f"Acc = {r['correct']} / {r['evaluated']} = {r['accuracy_pct']:.2f}")
    elif cmd == "sjeva":
        truth = argv[2] if len(argv) > 2 else "junctions.txt"
        r = sj_evaluation(argv[1], truth)
        print(f"# of SJ = {r['annotated_sj']}\n# of Reported SJ = "
              f"{r['reported_sj']}\nAcc = {r['correct']} ({r['precision_pct']:.2f}%)")
    else:
        print(f"unknown evaluation command: {cmd}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
