"""Vectorized FASTQ/FASTA chunk reader: parses whole buffers with
NumPy into the blob+offsets form the native pipeline consumes, instead
of materializing a Python object per read.

Semantics mirror io/fastx (and the reference GetData.cpp): headers
truncate at the first space/'/'/tab, the 2nd mate of paired input is
reverse-complemented (qualities reversed) at load, chunks close at the
read-count limit. Used for single-end and interleaved paired input on
uncompressed files + gzip (whole-stream decode); split-file pairs fall
back to the per-record reader.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..constants import (CHUNK_BASE_LIMIT, NT4_TABLE, RAMP_READS,
                         READ_CHUNK_SIZE)

COMP_CODES = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in [("A", "T"), ("a", "T"), ("C", "G"), ("c", "G"),
               ("G", "C"), ("g", "C"), ("T", "A"), ("t", "A")]:
    COMP_CODES[ord(_a)] = ord(_b)


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


def _header_spans(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Header begin/end per reference semantics: skip the '>'/'@' run,
    cut at the first space/'/'/tab (else the full line)."""
    # begin: first char after the marker run; the reference skips ALL
    # leading '>'/'@' (GetData.cpp:55-63)
    begs = starts + 1
    # extend past any additional marker chars (rare)
    for _ in range(2):
        at = buf[np.minimum(begs, buf.shape[0] - 1)]
        more = (begs < ends) & ((at == ord(">")) | (at == ord("@")))
        if not more.any():
            break
        begs = begs + more
    # scan only the header bytes (a small fraction of the buffer) for
    # the first space/'/'/tab per line
    lens = ends - begs
    off = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    out_end = ends.copy()
    if total:
        idx = np.arange(total, dtype=np.int64) + np.repeat(begs - off[:-1],
                                                           lens)
        hb = buf[idx]
        cut = (hb == ord(" ")) | (hb == ord("/")) | (hb == ord("\t"))
        cut_pos = np.flatnonzero(cut)
        if cut_pos.size:
            rows = np.searchsorted(off, cut_pos, side="right") - 1
            first = np.full(lens.shape[0], np.iinfo(np.int64).max,
                            dtype=np.int64)
            np.minimum.at(first, rows, cut_pos)
            has = first < np.iinfo(np.int64).max
            ri = np.flatnonzero(has)
            out_end[ri] = begs[ri] + (first[ri] - off[ri])
    return begs, out_end


class FastChunkReader:
    """Chunked vectorized reader over one (optionally gzipped) file.
    Supports single-end and interleaved paired-end FASTQ/FASTA."""

    def __init__(self, path: str, pair_end: bool, chunk_reads: int,
                 ramp: bool = True):
        self._ramp = ramp
        raw = open(path, "rb").read()
        if path.endswith(".gz"):
            raw = gzip.decompress(raw)
        self.buf = np.frombuffer(raw, dtype=np.uint8)
        self.raw = raw
        self.fastq = raw[:1] == b"@"
        self.pair_end = pair_end
        self.chunk_reads = chunk_reads
        # same base cap as the streaming reader (reference: 1 Mbase per
        # 4000-read chunk, GetData.cpp:176): long-read inputs would
        # otherwise materialize a chunk_reads x max_len codes matrix
        self.chunk_bases = CHUNK_BASE_LIMIT * max(
            1, chunk_reads // READ_CHUNK_SIZE)
        self._parse()
        self.cursor = 0
        # first-chunk ramp (constants.RAMP_READS); later files of a
        # multi-file stream skip it — the pipeline is already hot, and
        # a 4096-read chunk costs nearly as much wall as a full one
        self._first = self._ramp

    def _parse(self):
        buf = self.buf
        nl = np.flatnonzero(buf == 10)
        if buf.shape[0] and buf[-1] != 10:
            nl = np.concatenate([nl, [buf.shape[0]]])
        line_starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
        line_ends = nl.astype(np.int64)  # exclusive of newline
        if self.fastq:
            n = line_starts.shape[0] // 4
            hs = line_starts[0::4][:n]
            he = line_ends[0::4][:n]
            ss = line_starts[1::4][:n]
            se = line_ends[1::4][:n]
            qs = line_starts[3::4][:n]
            # qual truncated to seq length (reference: GetData.cpp)
            qe = np.minimum(qs + (se - ss), line_ends[3::4][:n])
            self.n_reads = n
            self.seq_s, self.seq_e = ss, se
            self.qual_s, self.qual_e = qs, qe
            hb, hcut = _header_spans(buf, hs, he)
            self.hdr_s, self.hdr_e = hb, hcut
            self.rec_lens = (se - ss).astype(np.int64)
        else:
            # FASTA with arbitrary line wrapping: record = '>' line +
            # following sequence lines concatenated
            is_hdr = buf[line_starts] == ord(">")
            hdr_idx = np.flatnonzero(is_hdr)
            n = hdr_idx.shape[0]
            self.n_reads = n
            hs = line_starts[hdr_idx]
            he = line_ends[hdr_idx]
            hb, hcut = _header_spans(buf, hs, he)
            self.hdr_s, self.hdr_e = hb, hcut
            # per-record sequence line ranges
            next_hdr = np.concatenate([hdr_idx[1:], [line_starts.shape[0]]])
            self.fa_line_starts = line_starts
            self.fa_line_ends = line_ends
            self.fa_first = hdr_idx + 1
            self.fa_last = next_hdr  # exclusive
            self.qual_s = self.qual_e = None
            self.seq_s = self.seq_e = None
            llen = (line_ends - line_starts).astype(np.int64)
            cl = np.zeros(llen.shape[0] + 1, dtype=np.int64)
            np.cumsum(llen, out=cl[1:])
            self.rec_lens = cl[np.minimum(self.fa_last, llen.shape[0])] - \
                cl[np.minimum(self.fa_first, llen.shape[0])]

    def _fasta_seq_blob(self, a, b):
        """Sequences of records [a, b): wrapped lines concatenated."""
        n = b - a
        parts = []
        lens = np.zeros(n, dtype=np.int64)
        for i in range(n):
            j0 = self.fa_first[a + i]
            j1 = self.fa_last[a + i]
            s = b"".join(self.raw[self.fa_line_starts[j]:self.fa_line_ends[j]]
                         for j in range(j0, j1))
            parts.append(s)
            lens[i] = len(s)
        seq_blob = b"".join(parts)
        seq_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=seq_off[1:])
        return seq_blob, seq_off

    def _slice_blob(self, starts, ends):
        lens = ends - starts
        off = np.zeros(lens.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        total = int(off[-1])
        idx = np.arange(total, dtype=np.int64) + np.repeat(
            starts - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        blob = self.buf[idx].tobytes() if total else b""
        return blob, off

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
        sl = slice(a, b)
        n = b - a
        if self.fastq:
            seq_blob, seq_off = self._slice_blob(self.seq_s[sl], self.seq_e[sl])
            qual_blob, qual_off = self._slice_blob(self.qual_s[sl], self.qual_e[sl])
        else:
            seq_blob, seq_off = self._fasta_seq_blob(a, b)
            qual_blob, qual_off = b"", None
        hdr_blob, hdr_off = self._slice_blob(self.hdr_s[sl], self.hdr_e[sl])
        if self.pair_end and self.fastq:
            seq_blob, qual_blob = _revcomp_second_mates(
                seq_blob, seq_off, qual_blob, qual_off)
        elif self.pair_end:
            seq_blob, _ = _revcomp_second_mates(seq_blob, seq_off, None, None)
        return BlobChunk(n, seq_blob, seq_off, hdr_blob, hdr_off,
                         qual_blob, qual_off, self.fastq)

    def close(self):
        # drop the whole-file buffer and record-index arrays promptly:
        # with chunks from the NEXT file already in flight while this
        # file drains, two readers overlap — releasing eagerly narrows
        # allocator-lifetime interleaving (measured: a 600-file 60M-read
        # stream crept ~5 MB RSS per file from arena fragmentation)
        for f in ("buf", "seq_s", "seq_e", "qual_s", "qual_e",
                  "name_s", "name_e", "rec_lens", "fa_last"):
            if hasattr(self, f):
                setattr(self, f, None)


class FastPairedReader:
    """Split-file paired input (-f/-f2): both files parse vectorized;
    chunks interleave mate1/mate2 per pair with the 2nd mate
    reverse-complemented, matching the streaming reader's layout."""

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

    @staticmethod
    def _interleave(bufA, sA, eA, bufB, sB, eB):
        lensA = (eA - sA).astype(np.int64)
        lensB = (eB - sB).astype(np.int64)
        n = lensA.shape[0]
        lens = np.empty(2 * n, np.int64)
        lens[0::2] = lensA
        lens[1::2] = lensB
        off = np.zeros(2 * n + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        out = np.empty(int(off[-1]), np.uint8)

        # uniform-length fast path (the normal case: fixed-length
        # reads/quals): one 2D gather per side into a reshaped view —
        # no per-byte int64 src/tgt index construction
        if (n and lensA.min() == lensA.max()
                and lensB.min() == lensB.max()):
            la, lb = int(lensA[0]), int(lensB[0])
            m = out.reshape(n, la + lb)
            if la:
                m[:, :la] = bufA[sA.astype(np.int64)[:, None]
                                 + np.arange(la)]
            if lb:
                m[:, la:] = bufB[sB.astype(np.int64)[:, None]
                                 + np.arange(lb)]
            return out.tobytes(), off

        def place(buf, starts, seg_lens, tgt_starts):
            total = int(seg_lens.sum())
            if not total:
                return
            c0 = np.zeros(seg_lens.shape[0], np.int64)
            np.cumsum(seg_lens[:-1], out=c0[1:])
            k = np.arange(total, dtype=np.int64)
            src = k + np.repeat(starts - c0, seg_lens)
            tgt = k + np.repeat(tgt_starts - c0, seg_lens)
            out[tgt] = buf[src]

        place(bufA, sA.astype(np.int64), lensA, off[0:-1:2])
        place(bufB, sB.astype(np.int64), lensB, off[1::2])
        return out.tobytes(), off

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
        sl = slice(a, b)
        r1, r2 = self.r1, self.r2
        if self.fastq:
            seq_blob, seq_off = self._interleave(
                r1.buf, r1.seq_s[sl], r1.seq_e[sl],
                r2.buf, r2.seq_s[sl], r2.seq_e[sl])
            qual_blob, qual_off = self._interleave(
                r1.buf, r1.qual_s[sl], r1.qual_e[sl],
                r2.buf, r2.qual_s[sl], r2.qual_e[sl])
        else:
            b1, o1 = r1._fasta_seq_blob(a, b)
            b2, o2 = r2._fasta_seq_blob(a, b)
            seq_blob, seq_off = self._interleave(
                np.frombuffer(b1, np.uint8), o1[:-1], o1[1:],
                np.frombuffer(b2, np.uint8), o2[:-1], o2[1:])
            qual_blob, qual_off = b"", None
        hdr_blob, hdr_off = self._interleave(
            r1.buf, r1.hdr_s[sl], r1.hdr_e[sl],
            r2.buf, r2.hdr_s[sl], r2.hdr_e[sl])
        seq_blob, qual_blob = _revcomp_second_mates(
            seq_blob, seq_off, qual_blob if self.fastq else None, qual_off)
        return BlobChunk(2 * (b - a), seq_blob, seq_off, hdr_blob, hdr_off,
                         qual_blob, qual_off, self.fastq)

    def close(self):
        self.r1.close()
        self.r2.close()


def _revcomp_second_mates(seq_blob, seq_off, qual_blob, qual_off):
    """Reverse-complement every odd-indexed read in place (the 2nd mate
    of interleaved pairs; GetData.cpp:157-168)."""
    arr = np.frombuffer(seq_blob, dtype=np.uint8).copy()
    q = (np.frombuffer(qual_blob, dtype=np.uint8).copy()
         if qual_blob else None)
    n = seq_off.shape[0] - 1
    odd = np.arange(1, n, 2)
    lens = (seq_off[odd + 1] - seq_off[odd]).astype(np.int64)
    if odd.size and lens.min() == lens.max():
        # uniform-length fast path: one gather/flip/scatter matrix op
        # instead of a Python loop over mates
        ln = int(lens[0])
        idx = seq_off[odd].astype(np.int64)[:, None] + np.arange(ln)
        arr[idx] = COMP_CODES[arr[idx]][:, ::-1]
        if q is not None:
            qidx = (qual_off[odd].astype(np.int64)[:, None]
                    + np.arange(ln))
            q[qidx] = q[qidx][:, ::-1]
        return arr.tobytes(), (q.tobytes() if q is not None else qual_blob)
    for i in range(1, n, 2):
        s, e = int(seq_off[i]), int(seq_off[i + 1])
        arr[s:e] = COMP_CODES[arr[s:e]][::-1]
        if q is not None:
            qs, qe = int(qual_off[i]), int(qual_off[i + 1])
            q[qs:qe] = q[qs:qe][::-1]
    return arr.tobytes(), (q.tobytes() if q is not None else qual_blob)
