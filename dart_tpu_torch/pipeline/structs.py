"""Core pipeline datatypes (reference: structure.h:106-164)."""

from __future__ import annotations


class SeedPair:
    """One read-block/genome-block pair. bSimple marks exact-match
    ("simple") pairs from seeding; normal pairs close gaps."""

    __slots__ = ("bSimple", "bAcceptorSite", "rPos", "gPos", "rLen", "gLen", "PosDiff")

    def __init__(self, rPos=0, gPos=0, rLen=0, gLen=0, PosDiff=0,
                 bSimple=False, bAcceptorSite=False):
        self.rPos = rPos
        self.gPos = gPos
        self.rLen = rLen
        self.gLen = gLen
        self.PosDiff = PosDiff
        self.bSimple = bSimple
        self.bAcceptorSite = bAcceptorSite

    def __repr__(self):
        return (f"SeedPair(r[{self.rPos}-{self.rPos+self.rLen-1}] "
                f"g[{self.gPos}-{self.gPos+self.gLen-1}] diff={self.PosDiff} "
                f"{'S' if self.bSimple else 'N'})")


class AlignmentCandidate:
    __slots__ = ("Score", "SJtype", "PosDiff", "PairedAlnCanIdx", "SeedVec")

    def __init__(self):
        self.Score = 0
        self.SJtype = -1
        self.PosDiff = 0
        self.PairedAlnCanIdx = -1
        self.SeedVec: list[SeedPair] = []


class Coordinate:
    __slots__ = ("bDir", "CIGAR", "gPos", "ChromosomeIdx")

    def __init__(self):
        self.bDir = True
        self.CIGAR = ""
        self.gPos = 0
        self.ChromosomeIdx = 0


class AlignmentReport:
    __slots__ = ("AlnScore", "SJtype", "iFrag", "PairedAlnCanIdx", "coor")

    def __init__(self):
        self.AlnScore = 0
        self.SJtype = -1
        self.iFrag = 0
        self.PairedAlnCanIdx = -1
        self.coor = Coordinate()


def sort_by_genome_pos(seeds: list[SeedPair]) -> None:
    """CompByGenomePos (AlignmentCandidates.cpp:21-25)."""
    seeds.sort(key=lambda s: (s.gPos, s.rPos))


def show_candidate_info(idx, b_first_read: bool, header: str,
                        alignments: list[AlignmentCandidate]) -> None:
    """-d trace (ShowAlignmentCandidateInfo, Mapping.cpp:50-66 +
    ShowSeedInfo, tools.cpp:116-128)."""
    print("\n" + "-" * 100)
    print(f"Alignment Candidate for read {header} /{1 if b_first_read else 2}")
    for c_i, can in enumerate(alignments):
        if can.Score == 0:
            continue
        print(f"\tcandidate#{c_i + 1}: Score={can.Score}")
        for s_i, s in enumerate(can.SeedVec):
            if s.rLen > 0 or s.gLen > 0:
                print(f"\t\tseed#{s_i + 1}: R[{s.rPos}-{s.rPos + s.rLen - 1}]"
                      f"={s.rLen} G[{s.gPos}-{s.gPos + s.gLen - 1}]={s.gLen} "
                      f"Diff={s.PosDiff} "
                      f"{'Simple' if s.bSimple else 'Normal'}")
                g = s.gPos if s.gPos < idx.genome_size else s.gPos + s.gLen - 1
                k = idx.chr_lower_bound(g)
                ci = int(idx.chr_end_idx[k])
                loc = (g - idx.chromosomes[ci].forward_location
                       if g < idx.genome_size
                       else int(idx.chr_end_keys[k]) - g)
                print(f"\t\t\t\t\tChr [{idx.chromosomes[ci].name}, {loc}]")
        print("\n")
    print("-" * 100 + "\n")
