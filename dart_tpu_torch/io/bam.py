"""BAM output: BGZF container + SAM-record binary encoding.

The reference produces BAM by round-tripping its own SAM text through
htslib (Mapping.cpp:655-663). We encode directly: SAM text line ->
binary BAM record, BGZF-compressed with zlib. Output is semantically
identical (same records), not byte-identical (compression framing may
differ from htslib's).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import NamedTuple

import numpy as np

from ..spans import span

SEQ_NT16 = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}
CIGAR_OPS = {op: i for i, op in enumerate("MIDNSHP=X")}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _deflate_block(raw: bytes, level: int = 1) -> bytes:
    """One complete BGZF member for `raw` (<= MAX_BLOCK bytes): the
    readable twin of native/bgzf.cpp, which deflates the full blocks of
    a write, and the framing of the short blocks that flush_boundary
    and close write.

    level defaults to 1: deflate is ~half the PE+BAM wall on a
    one-core host at htslib's default 6, and the BAM contract here is
    record identity, not byte identity (compression framing already
    differs from htslib). --bam-level restores denser output."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(raw) + co.flush()
    bsize = len(comp) + 25 + 1
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,   # gzip magic, deflate, FEXTRA
        0, 0, 0xFF,          # mtime, xfl, os
        6,                   # xlen
        66, 67, 2,           # 'B' 'C' slen
        bsize - 1,
    )
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    return header + comp + struct.pack("<II", crc, len(raw))


class Native(NamedTuple):
    """The native library's BAM entries, each None where it is missing."""
    encode: object  # dart_sam_to_bam_mt
    deflate: object  # dart_bgzf_deflate


@functools.cache
def _native() -> Native:
    """The encoder where the native library loads, and the BGZF deflate
    where it was built with zlib and that zlib is the runtime of
    Python's zlib module, whose bytes its members must equal."""
    from ..native import build as native_build

    lib = native_build.load()
    encode = deflate = None
    if lib is not None and hasattr(lib, "dart_sam_to_bam_mt"):
        encode = lib.dart_sam_to_bam_mt
        encode.restype = ctypes.c_int64
        encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    if lib is not None and hasattr(lib, "dart_bgzf_deflate"):
        lib.dart_bgzf_zlib_version.restype = ctypes.c_char_p
        lib.dart_bgzf_zlib_version.argtypes = []
        if lib.dart_bgzf_zlib_version().decode() == zlib.ZLIB_RUNTIME_VERSION:
            deflate = lib.dart_bgzf_deflate
            deflate.restype = ctypes.c_int64
            deflate.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    return Native(encode, deflate)


def _room(buf: np.ndarray, need: int, keep: int = 0) -> np.ndarray:
    """`buf`, or a larger one holding its first `keep` bytes, with room
    for `need` bytes: the writers' buffers are kept across writes and
    grow only when a write needs more."""
    if need <= len(buf):
        return buf
    grown = np.empty(max(need, 2 * len(buf)), np.uint8)
    grown[:keep] = buf[:keep]
    return grown


class BgzfWriter:
    MAX_BLOCK = 65280
    MAX_MEMBER = 65536  # BSIZE is 16 bits

    def __init__(self, path: str, append: bool = False, threads: int = 1,
                 level: int = 1):
        self.fh = open(path, "ab" if append else "wb")
        self.level = level
        self.threads = max(1, threads)
        self._deflate = _native().deflate
        self._pool = None
        if threads > 1 and self._deflate is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(threads)
        # raw[:n] is the tail that fills no block yet; out takes one
        # write's members
        self._raw = np.empty(self.MAX_BLOCK, np.uint8)
        self._n = 0
        self._out = np.empty(0, np.uint8)
        self.deflated_bytes = 0  # the bytes framed into members
        self.native_bytes = 0  # of those, the bytes native/bgzf.cpp framed

    def reserve(self, n: int) -> int:
        """The address of room for `n` bytes after the tail, where a
        native encoder writes; commit(k) then writes the first k. Valid
        until the writer's next call."""
        self._raw = _room(self._raw, self._n + n, self._n)
        return self._raw.ctypes.data + self._n

    def write(self, data: bytes) -> None:
        n = len(data)
        self.reserve(n)
        self._raw[self._n:self._n + n] = np.frombuffer(data, np.uint8)
        self.commit(n)

    def commit(self, n: int) -> None:
        """Take `n` bytes written after the tail; deflate and write every
        full block (on the -t threads), keeping the rest as the tail."""
        self._n += n
        n_full = self._n // self.MAX_BLOCK
        if not n_full:
            return
        full = n_full * self.MAX_BLOCK
        if self._deflate is not None:
            cap = n_full * self.MAX_MEMBER
            self._out = _room(self._out, cap)
            m = self._deflate(self._raw.ctypes.data, n_full, self.level,
                              self.threads, self._out.ctypes.data, cap)
            if m < 0:
                raise RuntimeError(f"dart_bgzf_deflate failed ({m})")
            self.fh.write(self._out[:m])
            self.native_bytes += full
        else:
            blocks = [self._raw[i * self.MAX_BLOCK:(i + 1) * self.MAX_BLOCK]
                      .tobytes() for i in range(n_full)]
            enc = functools.partial(_deflate_block, level=self.level)
            if self._pool is not None and n_full > 1:
                members = self._pool.map(enc, blocks)  # ordered
            else:
                members = map(enc, blocks)
            for comp in members:
                self.fh.write(comp)
        self.deflated_bytes += full
        rest = self._n - full
        self._raw[:rest] = self._raw[full:self._n]
        self._n = rest

    def _write_tail(self) -> None:
        if self._n:
            self.fh.write(_deflate_block(self._raw[:self._n].tobytes(),
                                         self.level))
            self.deflated_bytes += self._n
            self._n = 0

    def flush_boundary(self) -> int:
        """Flush any buffered bytes as a (possibly short) BGZF block
        and return the file offset — a valid truncation point for
        checkpoint/resume (BGZF blocks are independent; a truncated
        file at a block boundary plus appended blocks is a valid
        stream)."""
        self._write_tail()
        self.fh.flush()
        return self.fh.tell()

    def close(self) -> None:
        self._write_tail()
        self.fh.write(BGZF_EOF)
        self.fh.close()
        if self._pool is not None:
            self._pool.shutdown()


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cig: str) -> list[tuple[int, int]]:
    out = []
    num = 0
    for ch in cig:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num, CIGAR_OPS[ch]))
            num = 0
    return out


def _encode_int_tag(tag: bytes, val: int) -> bytes:
    if 0 <= val <= 0xFF:
        return tag + b"C" + struct.pack("<B", val)
    if -128 <= val < 0:
        return tag + b"c" + struct.pack("<b", val)
    if 0 <= val <= 0xFFFF:
        return tag + b"S" + struct.pack("<H", val)
    if -32768 <= val < 0:
        return tag + b"s" + struct.pack("<h", val)
    return tag + b"i" + struct.pack("<i", val)


class BamWriter:
    def __init__(self, path: str, append: bool = False, threads: int = 1,
                 level: int = 1):
        """append=True reopens an existing stream at a BGZF block
        boundary (checkpoint resume): no header is rewritten, but
        write_header must still be called with the same lines to
        rebuild the reference-id map (it skips the output).
        threads>1 encodes and compresses on that many threads (htslib
        bgzf_mt analogue; only pays off on multi-core hosts)."""
        self.bgzf = BgzfWriter(path, append=append, threads=threads,
                                level=level)
        self.ref_ids: dict[str, int] = {}
        self._append = append

    def flush_boundary(self) -> int:
        """Flush to a BGZF block boundary; returns the checkpointable
        file offset."""
        return self.bgzf.flush_boundary()

    def write_header(self, header_lines: list[str]) -> None:
        text = "\n".join(header_lines) + "\n"
        refs = []
        for line in header_lines:
            if line.startswith("@SQ"):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:])
                refs.append((fields["SN"], int(fields["LN"])))
        for i, (name, _ln) in enumerate(refs):
            self.ref_ids[name] = i
        if self._append:
            return  # resume: header already in the file
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
        out += struct.pack("<i", len(refs))
        for name, ln in refs:
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self.bgzf.write(out)

    def write_sam_bytes(self, sam: bytes) -> None:
        """Encode a whole SAM-text chunk ('@' lines skipped) through
        the native encoder (native/bamenc.cpp) on the -t threads, into
        the BGZF writer's buffer after its tail — the BAM-output hot
        path, its encode and its BGZF deflate and write under
        dart.output.encode and dart.output.deflate spans; falls back to
        the per-record Python twin."""
        encode = _native().encode
        if encode is None:
            for line in sam.decode("latin-1").splitlines():
                if line and not line.startswith("@"):
                    self.write_record(line)
            return
        bgzf = self.bgzf
        with span("dart.output.encode"):
            names = ("\n".join(self.ref_ids) + "\n").encode()
            cap = len(sam) + len(sam) // 2 + 4096
            while (n := encode(sam, len(sam), names, bgzf.reserve(cap), cap,
                               bgzf.threads)) < 0:
                cap *= 2
        with span("dart.output.deflate"):
            bgzf.commit(n)

    def write_record(self, sam_line: str) -> None:
        f = sam_line.split("\t")
        qname, flag, rname, pos, mapq = f[0], int(f[1]), f[2], int(f[3]), int(f[4])
        cigar_str, rnext, pnext, tlen, seq, qual = f[5], f[6], int(f[7]), int(f[8]), f[9], f[10]
        tags = f[11:]

        ref_id = self.ref_ids.get(rname, -1)
        cigar = _parse_cigar(cigar_str) if cigar_str != "*" else []
        ref_len = sum(n for n, op in cigar if op in (0, 2, 3, 7, 8)) or 1
        p0 = pos - 1
        bin_ = _reg2bin(p0 if p0 >= 0 else 0, (p0 + ref_len) if p0 >= 0 else 1)
        if rnext == "=":
            next_ref = ref_id
        elif rnext == "*":
            next_ref = -1
        else:
            next_ref = self.ref_ids.get(rnext, -1)

        name_b = qname.encode() + b"\x00"
        rec = struct.pack(
            "<iiBBHHHiiii",
            ref_id, p0,
            len(name_b), mapq, bin_, len(cigar), flag,
            len(seq) if seq != "*" else 0,
            next_ref, pnext - 1, tlen,
        )
        rec += name_b
        for n, op in cigar:
            rec += struct.pack("<I", (n << 4) | op)
        if seq != "*":
            packed = bytearray((len(seq) + 1) // 2)
            for i, ch in enumerate(seq):
                code = SEQ_NT16.get(ch.upper(), 15)
                packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
            rec += bytes(packed)
            if qual == "*":
                rec += b"\xff" * len(seq)
            else:
                rec += bytes((ord(c) - 33) & 0xFF for c in qual)
        for tag in tags:
            # tags may contain a space-joined trailing XS:A (reference quirk)
            for part in tag.split(" "):
                if not part:
                    continue
                name, typ, val = part.split(":", 2)
                tb = name.encode()
                if typ == "i":
                    rec += _encode_int_tag(tb, int(val))
                elif typ == "A":
                    rec += tb + b"A" + val.encode()[:1]
                else:
                    rec += tb + b"Z" + val.encode() + b"\x00"
        self.bgzf.write(struct.pack("<i", len(rec)) + rec)

    def close(self) -> None:
        self.bgzf.close()
