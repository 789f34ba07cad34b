"""FASTQ/FASTA chunk readers over whole files in the blob+offsets form
the native pipeline consumes, without a Python object per read.

The byte work is the native library's (``native/fastx.cpp``): one pass
indexes a file's records, one copy loop a chunk writes its blobs, with
split-file pairs interleaved and the second mate of paired input
reverse-complemented (qualities reversed). Semantics mirror io/fastx
(and the reference GetData.cpp): headers truncate at the first
space/'/'/tab, chunks close at the read-count limit or the base cap.
Plain files and gzip (decoded whole) of single-end, interleaved and
split-file paired input.
"""

from __future__ import annotations

import ctypes
import gzip

import numpy as np

from ..constants import (CHUNK_BASE_LIMIT, NT4_TABLE, RAMP_READS,
                         READ_CHUNK_SIZE)
from ..native import build as native_build

# a record's row of the native index (native/fastx.cpp): header span,
# sequence extent, joined sequence length, quality span
_NF = 7
_SL = 4

_I64P = ctypes.POINTER(ctypes.c_int64)

# a new bytes object of n bytes left for the caller to fill, as C code
# builds one (PyBytes_FromStringAndSize(NULL, n)): the chunk's blobs are
# written in place by the native fill before any other reference exists
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p,
                               ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))


class BlobChunk:
    """One chunk of reads in structure-of-blobs form."""

    __slots__ = ("n", "seq_blob", "seq_off", "hdr_blob", "hdr_off",
                 "qual_blob", "qual_off", "fastq")

    def __init__(self, n, seq_blob, seq_off, hdr_blob, hdr_off,
                 qual_blob, qual_off, fastq):
        self.n = n
        self.seq_blob = seq_blob
        self.seq_off = seq_off
        self.hdr_blob = hdr_blob
        self.hdr_off = hdr_off
        self.qual_blob = qual_blob
        self.qual_off = qual_off
        self.fastq = fastq

    def __len__(self):
        return self.n

    def codes_matrix(self):
        """(R, L) uint8 2-bit codes (4 = N) + (R,) lengths."""
        lens = np.diff(self.seq_off)
        R = self.n
        L = int(lens.max()) if R else 1
        codes = np.full((R, L), 4, dtype=np.uint8)
        flat = NT4_TABLE[np.frombuffer(self.seq_blob, dtype=np.uint8)]
        # scatter each read's codes into its row
        idx = np.arange(self.seq_off[-1], dtype=np.int64)
        row = np.repeat(np.arange(R, dtype=np.int64), lens)
        col = idx - np.repeat(self.seq_off[:-1], lens)
        codes[row, col] = flat
        return codes, lens.astype(np.int32)

    # compatibility helpers for the non-native paths / summaries
    def seq(self, i):
        return self.seq_blob[self.seq_off[i]:self.seq_off[i + 1]]

    def header(self, i):
        return self.hdr_blob[self.hdr_off[i]:self.hdr_off[i + 1]].decode(
            "latin-1")


def _lib() -> ctypes.CDLL:
    """The native library, its input entry points declared."""
    lib = native_build.load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    lib.dart_fastx_count.restype = ctypes.c_int64
    lib.dart_fastx_count.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int32]
    lib.dart_fastx_index.restype = None
    lib.dart_fastx_index.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int64, _I64P]
    lib.dart_fastx_offsets.restype = None
    lib.dart_fastx_offsets.argtypes = [_I64P, _I64P, ctypes.c_int64,
                                       ctypes.c_int64, _I64P, _I64P, _I64P]
    lib.dart_fastx_fill.restype = None
    lib.dart_fastx_fill.argtypes = [
        ctypes.c_char_p, _I64P, ctypes.c_char_p, _I64P, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, _I64P, _I64P, _I64P,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    return lib


def _p64(a):
    return a.ctypes.data_as(_I64P)


def _blob_chunk(r1, r2, a: int, n: int, revcomp: bool) -> BlobChunk:
    """The n reads from record a of ``r1``'s file, or, with ``r2``, the
    n / 2 pairs from pair a of the two files, mates in turn."""
    lib = r1._lib
    offs = [np.empty(n + 1, np.int64) for _ in range(3)]
    rows2 = _p64(r2.rows) if r2 is not None else None
    lib.dart_fastx_offsets(_p64(r1.rows), rows2, a, n, *map(_p64, offs))
    seq, qual, hdr = (_new_bytes(None, int(o[-1])) for o in offs)
    lib.dart_fastx_fill(r1.raw, _p64(r1.rows),
                        r2.raw if r2 is not None else None, rows2, a, n,
                        int(revcomp), *map(_p64, offs), seq, qual, hdr)
    if r1.fastq:
        return BlobChunk(n, seq, offs[0], hdr, offs[2], qual, offs[1], True)
    return BlobChunk(n, seq, offs[0], hdr, offs[2], b"", None, False)


class FastChunkReader:
    """Chunked reader over one (optionally gzipped) file.
    Supports single-end and interleaved paired-end FASTQ/FASTA."""

    def __init__(self, path: str, pair_end: bool, chunk_reads: int,
                 ramp: bool = True):
        self._ramp = ramp
        with open(path, "rb") as f:
            raw = f.read()
        if path.endswith(".gz"):
            raw = gzip.decompress(raw)
        self.raw = raw
        self.fastq = raw[:1] == b"@"
        self.pair_end = pair_end
        self.chunk_reads = chunk_reads
        # same base cap as the streaming reader (reference: 1 Mbase per
        # 4000-read chunk, GetData.cpp:176): long-read inputs would
        # otherwise materialize a chunk_reads x max_len codes matrix
        self.chunk_bases = CHUNK_BASE_LIMIT * max(
            1, chunk_reads // READ_CHUNK_SIZE)
        self._lib = lib = _lib()
        fastq = int(self.fastq)
        self.n_reads = lib.dart_fastx_count(raw, len(raw), fastq)
        self.rows = np.empty((self.n_reads, _NF), np.int64)
        lib.dart_fastx_index(raw, len(raw), fastq, self.n_reads,
                             _p64(self.rows))
        self.rec_lens = self.rows[:, _SL]
        self.cursor = 0
        # first-chunk ramp (constants.RAMP_READS); later files of a
        # multi-file stream skip it — the pipeline is already hot, and
        # a 4096-read chunk costs nearly as much wall as a full one
        self._first = self._ramp

    def next_chunk(self):
        a = self.cursor
        lim = self.chunk_reads
        if self._first:
            self._first = False
            if lim > RAMP_READS:
                lim = RAMP_READS
        # the streaming reader pulls records pairwise, so chunk sizes
        # round up to even (GetNextChunk semantics); it also closes a
        # chunk at the first pair that pushes cumulative bases past the
        # chunk_bases cap — replicated here over the precomputed
        # record-length prefix sums
        max_n = min((lim + 1) & ~1, self.n_reads - a)
        if max_n <= 0:
            return None
        cum = np.cumsum(self.rec_lens[a:a + max_n])
        pair_ends = np.arange(2, max_n + 1, 2)
        if pair_ends.size:
            over = cum[pair_ends - 1] > self.chunk_bases
            n_take = int(pair_ends[over.argmax()]) if over.any() else max_n
        else:
            n_take = max_n
        b = a + n_take
        if b <= a:
            return None
        self.cursor = b
        return _blob_chunk(self, None, a, b - a, self.pair_end)

    def close(self):
        # drop the whole-file buffer and the record index promptly:
        # with chunks from the NEXT file already in flight while this
        # file drains, two readers overlap — releasing eagerly narrows
        # allocator-lifetime interleaving (measured: a 600-file 60M-read
        # stream crept ~5 MB RSS per file from arena fragmentation)
        self.raw = self.rows = self.rec_lens = None


class FastPairedReader:
    """Split-file paired input (-f/-f2): chunks interleave mate1/mate2
    per pair with the 2nd mate reverse-complemented, matching the
    streaming reader's layout."""

    def __init__(self, path1: str, path2: str, chunk_reads: int,
                 ramp: bool = True):
        self.r1 = FastChunkReader(path1, False, chunk_reads)
        self.r2 = FastChunkReader(path2, False, chunk_reads)
        self.fastq = self.r1.fastq
        self.pair_end = True
        self.pairs_per_chunk = ((chunk_reads + 1) & ~1) // 2
        self.chunk_bases = CHUNK_BASE_LIMIT * max(
            1, chunk_reads // READ_CHUNK_SIZE)
        self.cursor = 0
        self.n_pairs = min(self.r1.n_reads, self.r2.n_reads)
        self._first = ramp  # first-chunk ramp (constants.RAMP_READS)

    def next_chunk(self):
        a = self.cursor
        lim_p = self.pairs_per_chunk
        if self._first:
            self._first = False
            if lim_p > RAMP_READS // 2:
                lim_p = RAMP_READS // 2
        max_p = min(lim_p, self.n_pairs - a)
        if max_p <= 0:
            return None
        # close at the first pair that pushes cumulative bases (both
        # mates) past the cap, mirroring the streaming reader
        cum = np.cumsum(self.r1.rec_lens[a:a + max_p] +
                        self.r2.rec_lens[a:a + max_p])
        over = cum > self.chunk_bases
        n_take = int(over.argmax()) + 1 if over.any() else max_p
        b = a + n_take
        if b <= a:
            return None
        self.cursor = b
        return _blob_chunk(self.r1, self.r2, a, 2 * (b - a), True)

    def close(self):
        self.r1.close()
        self.r2.close()
