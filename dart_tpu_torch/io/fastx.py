"""FASTA/FASTQ readers with the reference's exact parsing semantics
(Dart's src/GetData.cpp): header truncation at the first
space/slash/tab, per-line strip of exactly one trailing character for
multi-line FASTA, pairwise chunking with the 4000-read / 1 Mbase
limits, and reverse-complementing of the second mate at load time for
paired input (GetData.cpp:157-168).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from ..constants import (CHUNK_BASE_LIMIT, NT4_TABLE, RAMP_READS,
                         READ_CHUNK_SIZE)

COMP_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in [("A", "T"), ("a", "T"), ("C", "G"), ("c", "G"),
               ("G", "C"), ("g", "C"), ("T", "A"), ("t", "A")]:
    COMP_TABLE[ord(_a)] = ord(_b)


def revcomp_bytes(seq: bytes) -> bytes:
    arr = np.frombuffer(seq, dtype=np.uint8)
    return COMP_TABLE[arr][::-1].tobytes()


@dataclass
class ReadItem:
    header: str
    seq: bytes
    qual: bytes | None
    codes: np.ndarray = None  # uint8 per-base 2-bit codes (4 = N)
    # filled by the aligner:
    mapq: int = 0
    score: int = 0
    sub_score: int = 0
    mis_num: int = 0
    can_num: int = 0
    best_idx: int = 0
    reports: list = field(default_factory=list)

    @property
    def rlen(self) -> int:
        return len(self.seq)


def _parse_header(line: bytes) -> str:
    """IdentifyHeaderBegPos/EndPos semantics (GetData.cpp:55-75):
    start = first index >= 1 that is not '>'/'@'; end = first index >= 1
    that is space/slash/tab, else len-1 (which drops the newline)."""
    n = len(line)
    p1 = n - 1
    for i in range(1, n):
        if line[i : i + 1] not in (b">", b"@"):
            p1 = i
            break
    p2 = n - 1
    for i in range(1, n):
        if line[i : i + 1] in (b" ", b"/", b"\t"):
            p2 = i
            break
    return line[p1:p2].decode("latin-1")


class _LineReader:
    """Line source with one-line pushback, over plain or gz files."""

    def __init__(self, path: str, gz: bool):
        self.fh = gzip.open(path, "rb") if gz else open(path, "rb")
        self.pushed: bytes | None = None

    def getline(self) -> bytes | None:
        if self.pushed is not None:
            line, self.pushed = self.pushed, None
            return line
        line = self.fh.readline()
        return line if line else None

    def pushback(self, line: bytes) -> None:
        self.pushed = line

    def close(self):
        self.fh.close()


def _next_entry(r: _LineReader, fastq: bool) -> ReadItem | None:
    line = r.getline()
    if line is None:
        return None
    header = _parse_header(line)
    if fastq:
        seq_line = r.getline()
        if seq_line is None:
            return None
        seq = seq_line[:-1]  # reference drops the last char unconditionally
        r.getline()  # '+'
        qual_line = r.getline() or b""
        qual = qual_line[: len(seq)]
        return ReadItem(header, seq, qual)
    # FASTA: accumulate until the next '>' line
    parts = []
    while True:
        line = r.getline()
        if line is None:
            break
        if line.startswith(b">"):
            r.pushback(line)
            break
        # reference strips exactly the last character of each line
        parts.append(line[:-1])
    seq = b"".join(parts)
    if not seq:
        return None
    return ReadItem(header, seq, None)


def encode(read: ReadItem) -> None:
    read.codes = NT4_TABLE[np.frombuffer(read.seq, dtype=np.uint8)]


class ChunkReader:
    """Reference chunking semantics (GetNextChunk / gzGetNextChunk):
    entries are pulled pairwise; for paired-end input the second mate is
    reverse-complemented (and its quality reversed) at load; a chunk
    closes at READ_CHUNK_SIZE reads or > 1 Mbase."""

    def __init__(self, path1: str, path2: str | None, pair_end: bool,
                 chunk_reads: int = READ_CHUNK_SIZE,
                 chunk_bases: int | None = None, ramp: bool = True):
        self.chunk_reads = chunk_reads
        self.chunk_bases = (chunk_bases if chunk_bases is not None
                            else CHUNK_BASE_LIMIT * max(1, chunk_reads // READ_CHUNK_SIZE))
        gz = path1.endswith(".gz")
        self.fastq = _sniff_fastq(path1)
        self.r1 = _LineReader(path1, gz)
        self.r2 = _LineReader(path2, path2.endswith(".gz")) if path2 else None
        self.pair_end = pair_end or path2 is not None
        self.sep_library = path2 is not None
        self._first = ramp  # first-chunk ramp (constants.RAMP_READS)

    def next_chunk(self) -> list[ReadItem]:
        lim = self.chunk_reads
        if self._first:
            self._first = False
            if lim > RAMP_READS:
                lim = RAMP_READS
        out: list[ReadItem] = []
        bases = 0
        while True:
            a = _next_entry(self.r1, self.fastq)
            if a is None or a.rlen == 0:
                break
            encode(a)
            out.append(a)
            bases += a.rlen
            b = _next_entry(self.r2 if self.sep_library else self.r1, self.fastq)
            if b is None or b.rlen == 0:
                break
            if self.pair_end:
                b.seq = revcomp_bytes(b.seq)
                if self.fastq and b.qual is not None:
                    b.qual = b.qual[::-1]
            encode(b)
            out.append(b)
            bases += b.rlen
            if len(out) >= lim or bases > self.chunk_bases:
                break
        return out

    def close(self):
        self.r1.close()
        if self.r2:
            self.r2.close()


def _sniff_fastq(path: str) -> bool:
    """First byte '@' => FASTQ (Mapping.cpp:718-726)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        b = f.read(1)
    return b == b"@"
