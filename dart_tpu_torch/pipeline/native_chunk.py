"""ctypes bridge to the native host pipeline (native/pipeline.cpp).

The native library consumes whole read chunks (sequences, headers,
quality strings, and the per-occurrence seed tables produced by the
device seeding/locate kernels) and returns finished SAM text plus
per-chunk counters; the splice-junction map accumulates inside the
native context and is dumped once at the end of the run.

The pure-Python pipeline (chaining/finalize/report modules) remains
the parity oracle and the fallback when no C++ toolchain exists.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..index.loader import Index
from ..native import build as native_build

_C_FNS = None


def _bind():
    global _C_FNS
    if _C_FNS is not None:
        return _C_FNS
    lib = native_build.load()
    if lib is None or not hasattr(lib, "dart_pipe_create"):
        _C_FNS = False
        return False
    c = lib
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c.dart_pipe_create.restype = ctypes.c_void_p
    c.dart_pipe_create.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, ctypes.c_int32,
        ctypes.c_char_p, i64p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    c.dart_pipe_destroy.restype = None
    c.dart_pipe_destroy.argtypes = [ctypes.c_void_p]
    c.dart_pipe_chunk.restype = ctypes.c_int64
    c.dart_pipe_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_char_p, i64p, ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
        i64p, i32p, i32p, i64p, i64p, i64p]
    c.dart_pipe_sam_ptr.restype = ctypes.c_void_p
    c.dart_pipe_sam_ptr.argtypes = [ctypes.c_void_p]
    c.dart_pipe_sj_dump.restype = ctypes.c_int64
    c.dart_pipe_sj_dump.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_void_p)]
    _C_FNS = c
    return c


def available() -> bool:
    return _bind() is not False


_PACK_FN = None


def pack_reads_strided(seq_blob, seq_off, n_reads: int, words: int,
                       packed: np.ndarray, nmask: np.ndarray,
                       rlens: np.ndarray, has_n: np.ndarray) -> int | None:
    """Native chunk pack into caller-laid-out destinations (each a
    2-D/1-D uint32|int32 view whose row stride carries the layout —
    e.g. columns of one merged transfer buffer; see native/pack.cpp).
    Returns the count of reads containing ambiguous bases, or None
    when the native library is unavailable."""
    global _PACK_FN
    if _PACK_FN is None:
        lib = native_build.load()
        if lib is None or not hasattr(lib, "dart_pack_reads"):
            _PACK_FN = False
        else:
            lib.dart_pack_reads.restype = ctypes.c_int32
            lib.dart_pack_reads.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]
            _PACK_FN = lib.dart_pack_reads
    if _PACK_FN is False:
        return None
    blob = np.frombuffer(seq_blob, dtype=np.uint8)
    off = _i64(seq_off)

    def stride(a):
        return a.strides[0] // 4

    return _PACK_FN(
        _ptr(blob, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
        int(n_reads), int(words),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        stride(packed),
        nmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        stride(nmask),
        rlens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stride(rlens),
        has_n.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class NativePipeline:
    """Chunk-level host pipeline backed by native/pipeline.cpp."""

    def __init__(self, idx: Index, cfg):
        c = _bind()
        if c is False:
            raise RuntimeError("native pipeline unavailable")
        self._c = c
        self.idx = idx
        # keep marshaled arrays alive for the context's lifetime.
        # The genome buffer carries a 256-byte 'N' guard region at each
        # end: best_gapped_partition's continuation probes and
        # identify_sj's +/-9 bp motif reads may index a few bytes past
        # an alignment at the fwd/RC text boundary (the reference
        # allocates TwoGenomeSize+1 and relies on slack; guards make
        # the reads defined and never match A/C/G/T)
        from ..index.loader import REF_GUARD as GUARD
        if (getattr(idx, "ref_ascii_padded", None) is not None
                and idx.ref_ascii_padded.shape[0]
                == idx.ref_ascii.shape[0] + 2 * GUARD):
            # loader already allocated the guarded buffer; bind it
            # zero-copy (saves a genome-size alloc+copy — 6.2 GB at
            # GRCh38 scale)
            padded = idx.ref_ascii_padded
        else:
            padded = np.full(idx.ref_ascii.shape[0] + 2 * GUARD, ord("N"),
                             dtype=np.uint8)
            padded[GUARD:GUARD + idx.ref_ascii.shape[0]] = idx.ref_ascii
        self._ref = padded
        self._ref_base = ctypes.cast(
            ctypes.c_void_p(padded.ctypes.data + GUARD),
            ctypes.POINTER(ctypes.c_uint8))
        self._keys = _i64(idx.chr_end_keys)
        self._kidx = _i32(idx.chr_end_idx)
        self._fwd = _i64([ch.forward_location for ch in idx.chromosomes])
        names = "".join(ch.name + "\n" for ch in idx.chromosomes).encode()
        self._names = names
        self.ctx = c.dart_pipe_create(
            self._ref_base,
            int(idx.seq_len), int(idx.genome_size),
            _ptr(self._keys, ctypes.c_int64), _ptr(self._kidx, ctypes.c_int32),
            len(self._keys), names, _ptr(self._fwd, ctypes.c_int64),
            len(idx.chromosomes),
            int(cfg.max_gaps), int(cfg.max_intron_size),
            int(cfg.min_intron_size), int(cfg.max_mismatch),
            int(cfg.multi_hit), int(cfg.unique_only),
            int(cfg.find_all_junction))
        self.threads = int(cfg.threads)
        if not self.ctx:
            raise RuntimeError("dart_pipe_create failed")

    def __del__(self):
        ctx = getattr(self, "ctx", None)
        if ctx:
            self._c.dart_pipe_destroy(ctx)
            self.ctx = None

    def process_chunk(self, reads, pair_end: bool, fastq: bool,
                      occ_off, occ_rpos, occ_len, occ_gpos,
                      counters: dict, stats: dict | None = None) -> bytes:
        """Run chaining -> finalize -> output for one chunk. Seed inputs
        are the flattened per-occurrence tables (see seeding module).
        Returns the chunk's SAM text. ``stats``, when given, gains the
        seconds of the parallel compute phase and of the serial
        junction + SAM phase (finalize_parallel_s, finalize_serial_s)."""
        n = len(reads)
        if hasattr(reads, "seq_blob"):  # BlobChunk: zero-copy
            seq_blob = reads.seq_blob
            seq_off = _i64(reads.seq_off)
            hdr_blob = reads.hdr_blob
            hdr_off = _i64(reads.hdr_off)
            if fastq:
                qual_blob = reads.qual_blob
                qual_off = _i64(reads.qual_off)
                qptr = _ptr(qual_off, ctypes.c_int64)
            else:
                qual_blob = b""
                qptr = None
        else:
            seq_off = np.zeros(n + 1, dtype=np.int64)
            hdr_off = np.zeros(n + 1, dtype=np.int64)
            for i, r in enumerate(reads):
                seq_off[i + 1] = seq_off[i] + len(r.seq)
                hdr_off[i + 1] = hdr_off[i] + len(r.header)
            seq_blob = b"".join(r.seq for r in reads)
            hdr_blob = "".join(r.header for r in reads).encode("latin-1")
            if fastq:
                qual_off = np.zeros(n + 1, dtype=np.int64)
                for i, r in enumerate(reads):
                    qual_off[i + 1] = qual_off[i] + len(r.qual or b"")
                qual_blob = b"".join(r.qual or b"" for r in reads)
                qptr = _ptr(qual_off, ctypes.c_int64)
            else:
                qual_blob = b""
                qptr = None
        occ_off = _i64(occ_off)
        occ_rpos = _i32(occ_rpos)
        occ_len = _i32(occ_len)
        occ_gpos = _i64(occ_gpos)
        cnt = np.zeros(3, dtype=np.int64)
        phase_ns = np.zeros(2, dtype=np.int64)
        size = self._c.dart_pipe_chunk(
            self.ctx, n, int(pair_end), int(fastq), self.threads,
            seq_blob, _ptr(seq_off, ctypes.c_int64),
            qual_blob, qptr,
            hdr_blob, _ptr(hdr_off, ctypes.c_int64),
            _ptr(occ_off, ctypes.c_int64), _ptr(occ_rpos, ctypes.c_int32),
            _ptr(occ_len, ctypes.c_int32), _ptr(occ_gpos, ctypes.c_int64),
            _ptr(cnt, ctypes.c_int64), _ptr(phase_ns, ctypes.c_int64))
        counters["unique"] += int(cnt[0])
        counters["unmapped"] += int(cnt[1])
        counters["paired"] += int(cnt[2])
        counters["total"] += n
        if stats is not None:
            for key, ns in zip(("finalize_parallel_s", "finalize_serial_s"),
                               phase_ns.tolist()):
                stats[key] += ns * 1e-9
        ptr = self._c.dart_pipe_sam_ptr(self.ctx)
        return ctypes.string_at(ptr, size)

    def sj_items(self):
        """[(g1, g2, sj_type, count)] sorted by (g1, g2)."""
        out = ctypes.c_void_p()
        n = self._c.dart_pipe_sj_dump(self.ctx, ctypes.byref(out))
        if n == 0:
            return []
        buf = np.ctypeslib.as_array(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_int64)), shape=(n * 4,))
        q = buf.reshape(n, 4).copy()
        return [tuple(row) for row in q]
