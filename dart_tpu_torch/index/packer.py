"""FASTA packing: 2-bit encoding, contig metadata, ambiguity holes.

Produces byte-identical ``.pac`` / ``.ann`` / ``.amb`` files to the
reference index builder (format defined by
Dart's src/BWT_Index/bntseq.c:59-211), including the fixed-seed
lrand48 randomization of ambiguous bases (bntseq.c:144,173-174).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from ..constants import NT4_TABLE


def _native_lib():
    try:
        from ..native import build as native_build

        return native_build.load()
    except Exception:
        return None


class Lrand48:
    """drand48-family linear congruential generator (POSIX), as used by
    glibc's lrand48 after srand48(seed). Needed to reproduce the
    reference's N->random-base substitution exactly (seed 11)."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17

    def fill_bases(self, n: int) -> np.ndarray:
        """Return n random 2-bit bases (lrand48()&3 each). Native when
        available (an N-heavy genome — real GRCh38 carries ~150 Mb of
        N — would spend minutes in the Python loop)."""
        out = np.empty(n, dtype=np.uint8)
        lib = _native_lib()
        if lib is not None and hasattr(lib, "dart_lrand48_fill"):
            import ctypes

            state = np.array([self.x], dtype=np.uint64)
            lib.dart_lrand48_fill(
                state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(n))
            self.x = int(state[0])
            return out
        x, A, C, MASK = self.x, self.A, self.C, self.MASK
        for i in range(n):
            x = (A * x + C) & MASK
            out[i] = (x >> 17) & 3
        self.x = x
        return out


@dataclass
class Contig:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0


@dataclass
class AmbHole:
    offset: int
    length: int
    amb: str


@dataclass
class PackedGenome:
    """Forward-strand genome as 2-bit codes (N already randomized),
    plus contig and ambiguity metadata."""

    seq2: np.ndarray  # uint8 codes 0..3, length = l_pac
    contigs: list[Contig] = field(default_factory=list)
    holes: list[AmbHole] = field(default_factory=list)
    seed: int = 11

    @property
    def l_pac(self) -> int:
        return int(self.seq2.shape[0])


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str):
    """Yield (name, comment, sequence) per contig; sequence is a uint8
    ndarray (plain files, whole-buffer vectorized parse) or bytes (gz,
    streamed line loop) — pack_fasta accepts both. The line-by-line
    Python loop was 42 minutes of a 3.1 Gbp build; the vectorized
    parse is seconds."""
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    if not gz:
        yield from _iter_fasta_fast(path)
        return
    name = None
    comment = ""
    chunks: list[bytes] = []
    with _open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                header = line[1:].split(None, 1)
                name = header[0].decode()
                comment = header[1].decode() if len(header) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
        if name is not None:
            yield name, comment, b"".join(chunks)


def _iter_fasta_fast(path: str):
    """Whole-buffer FASTA parse: find header lines from newline
    positions, then mask-compress each contig's region (drop \\n/\\r) —
    identical yields to the line loop for any input whose sequence
    lines carry no other whitespace (bntseq.c's kseq makes the same
    assumption)."""
    with open(path, "rb") as f:
        data = f.read()
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 10)
    starts = np.empty(nl.size + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl + 1
    if starts.size and starts[-1] >= arr.size:  # file ends with \n
        starts = starts[:-1]
        line_ends = nl
    else:
        line_ends = np.append(nl, arr.size)
    hidx = np.flatnonzero(arr[starts] == ord(">"))
    for i, h in enumerate(hidx):
        line = data[starts[h]:line_ends[h]].rstrip(b"\r\n")
        header = line[1:].split(None, 1)
        name = header[0].decode()
        comment = header[1].decode() if len(header) > 1 else ""
        seq_beg = int(line_ends[h]) + 1
        seq_end = int(starts[hidx[i + 1]]) if i + 1 < hidx.size else arr.size
        if seq_beg >= seq_end:
            seq = np.empty(0, dtype=np.uint8)
        else:
            region = arr[seq_beg:seq_end]
            seq = region[(region != 10) & (region != 13)]
        yield name, comment, seq


def pack_fasta(path: str, seed: int = 11) -> PackedGenome:
    """Pack a FASTA file the way the reference does (bntseq.c:110-156):
    sequential scan, N runs recorded as holes, each ambiguous base
    replaced with lrand48()&3 using a generator seeded once up front."""
    rng = Lrand48(seed)
    pg = PackedGenome(seq2=np.empty(0, dtype=np.uint8), seed=seed)
    parts: list[np.ndarray] = []
    offset = 0
    for name, comment, seq in iter_fasta(path):
        arr = (seq if isinstance(seq, np.ndarray)
               else np.frombuffer(seq, dtype=np.uint8))
        codes = NT4_TABLE[arr].copy()
        amb_mask = codes >= 4
        n_ambs = 0
        if amb_mask.any():
            # Record holes: runs of ambiguous bases where the *character*
            # repeats contiguously (the reference groups by identical char:
            # bntseq.c:127 compares the raw character, not just "is N").
            # Run boundaries found vectorized: a new run starts wherever
            # the position or the raw character breaks continuity.
            idx = np.flatnonzero(amb_mask)
            brk = np.flatnonzero((idx[1:] != idx[:-1] + 1)
                                 | (arr[idx[1:]] != arr[idx[:-1]])) + 1
            run_beg = idx[np.concatenate([[0], brk])]
            run_end = idx[np.concatenate([brk - 1, [idx.size - 1]])]
            for rb, re_ in zip(run_beg, run_end):
                pg.holes.append(
                    AmbHole(offset + int(rb), int(re_ - rb + 1), chr(arr[rb])))
            n_ambs = int(run_beg.size)
            # lrand48 randomization is strictly sequential over ambiguous
            # positions in file order.
            codes[amb_mask] = rng.fill_bases(int(amb_mask.sum()))
        pg.contigs.append(Contig(name, comment or "(null)", offset, len(seq), n_ambs))
        parts.append(codes)
        offset += len(seq)
    pg.seq2 = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    return pg


def codes_to_pac_bytes(codes: np.ndarray) -> np.ndarray:
    """2-bit pack codes (values 0..3) into bytes, 4 bases per byte,
    first base in the top 2 bits (bntseq.c:107 _set_pac)."""
    n = codes.shape[0]
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    q = padded.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2 | q[:, 3]).astype(np.uint8)


def pac_bytes_to_codes(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of codes_to_pac_bytes."""
    b = pac.reshape(-1, 1)
    out = np.empty((pac.shape[0], 4), dtype=np.uint8)
    out[:, 0] = (b[:, 0] >> 6) & 3
    out[:, 1] = (b[:, 0] >> 4) & 3
    out[:, 2] = (b[:, 0] >> 2) & 3
    out[:, 3] = b[:, 0] & 3
    return out.reshape(-1)[:n]


def write_pac(path: str, codes: np.ndarray) -> None:
    """Write .pac: packed bases, then a pad byte if l%4==0, then l%4
    (bntseq.c:192-205)."""
    l_pac = codes.shape[0]
    pac = codes_to_pac_bytes(codes)
    with open(path, "wb") as f:
        f.write(pac.tobytes())
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def read_pac(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    rem = data[-1]
    n = (len(data) - 2) * 4 + rem if rem else (len(data) - 1) * 4
    # When rem == 0 the layout is pac-bytes + \x00 + \x00 and
    # len(data)-2 bytes of payload hold exactly n/4 bytes.
    if rem == 0:
        n = (len(data) - 2) * 4
    return pac_bytes_to_codes(np.frombuffer(data[: (n + 3) // 4], dtype=np.uint8), n)


def write_ann(path: str, pg: PackedGenome) -> None:
    """.ann format: bntseq.c:64-77."""
    with open(path, "w") as f:
        f.write(f"{pg.l_pac} {len(pg.contigs)} {pg.seed}\n")
        for c in pg.contigs:
            if c.anno:
                f.write(f"{c.gi} {c.name} {c.anno}\n")
            else:
                f.write(f"{c.gi} {c.name}\n")
            f.write(f"{c.offset} {c.length} {c.n_ambs}\n")


def write_amb(path: str, pg: PackedGenome) -> None:
    """.amb format: bntseq.c:78-88."""
    with open(path, "w") as f:
        f.write(f"{pg.l_pac} {len(pg.contigs)} {len(pg.holes)}\n")
        for h in pg.holes:
            f.write(f"{h.offset} {h.length} {h.amb}\n")


def read_ann(path: str) -> tuple[int, int, list[Contig]]:
    """Parse .ann; returns (l_pac, seed, contigs)."""
    with open(path) as f:
        tok = f.readline().split()
        l_pac, n_seqs, seed = int(tok[0]), int(tok[1]), int(tok[2])
        contigs = []
        for _ in range(n_seqs):
            line1 = f.readline().split(None, 2)
            gi = int(line1[0])
            name = line1[1]
            anno = line1[2].rstrip("\n") if len(line1) > 2 else ""
            tok = f.readline().split()
            contigs.append(Contig(name, anno, int(tok[0]), int(tok[1]), int(tok[2]), gi))
    return l_pac, seed, contigs
