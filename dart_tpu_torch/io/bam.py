"""BAM output: BGZF container + SAM-record binary encoding.

The reference produces BAM by round-tripping its own SAM text through
htslib (Mapping.cpp:655-663). We encode directly: SAM text line ->
binary BAM record, BGZF-compressed with zlib. Output is semantically
identical (same records), not byte-identical (compression framing may
differ from htslib's).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

from ..spans import span

SEQ_NT16 = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}
CIGAR_OPS = {op: i for i, op in enumerate("MIDNSHP=X")}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _deflate_block(raw: bytes, level: int = 1) -> bytes:
    """One complete BGZF member for `raw` (<= MAX_BLOCK bytes). Pure
    function of its input, so blocks compress in parallel: zlib
    releases the GIL, making a plain thread pool an effective -t
    analogue of htslib's bgzf_mt writer threads.

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


class BgzfWriter:
    MAX_BLOCK = 65280

    def __init__(self, path: str, append: bool = False, threads: int = 1,
                 level: int = 1):
        self.fh = open(path, "ab" if append else "wb")
        self.buf = bytearray()
        self.level = level
        self._pool = None
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(threads)

    def write(self, data: bytes) -> None:
        self.buf += data
        n_full = len(self.buf) // self.MAX_BLOCK
        if not n_full:
            return
        blocks = [bytes(self.buf[i * self.MAX_BLOCK:(i + 1) * self.MAX_BLOCK])
                  for i in range(n_full)]
        del self.buf[: n_full * self.MAX_BLOCK]
        if self._pool is not None and len(blocks) > 1:
            # parallel compress, ordered write
            import functools

            enc = functools.partial(_deflate_block, level=self.level)
            for comp in self._pool.map(enc, blocks):
                self.fh.write(comp)
        else:
            for raw in blocks:
                self.fh.write(_deflate_block(raw, self.level))

    def flush_boundary(self) -> int:
        """Flush any buffered bytes as a (possibly short) BGZF block
        and return the file offset — a valid truncation point for
        checkpoint/resume (BGZF blocks are independent; a truncated
        file at a block boundary plus appended blocks is a valid
        stream)."""
        if self.buf:
            self.fh.write(_deflate_block(bytes(self.buf), self.level))
            self.buf.clear()
        self.fh.flush()
        return self.fh.tell()

    def close(self) -> None:
        if self.buf:
            self.fh.write(_deflate_block(bytes(self.buf), self.level))
            self.buf.clear()
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
        threads>1 compresses BGZF blocks in parallel (htslib bgzf_mt
        analogue; only pays off on multi-core hosts)."""
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

    _ENC = None

    def write_sam_bytes(self, sam: bytes) -> None:
        """Encode a whole SAM-text chunk ('@' lines skipped) through
        the native encoder (native/bamenc.cpp) — the BAM-output hot
        path, its encode and its BGZF deflate and write under
        dart.output.encode and dart.output.deflate spans; falls back to
        the per-record Python twin."""
        if BamWriter._ENC is None:
            from ..native import build as native_build

            lib = native_build.load()
            if lib is None or not hasattr(lib, "dart_sam_to_bam"):
                BamWriter._ENC = False
            else:
                lib.dart_sam_to_bam.restype = ctypes.c_int64
                lib.dart_sam_to_bam.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
                BamWriter._ENC = lib.dart_sam_to_bam
        if BamWriter._ENC is False:
            for line in sam.decode("latin-1").splitlines():
                if line and not line.startswith("@"):
                    self.write_record(line)
            return
        with span("dart.output.encode"):
            names = ("\n".join(self.ref_ids) + "\n").encode()
            cap = len(sam) + len(sam) // 2 + 4096
            while True:
                buf = (ctypes.c_uint8 * cap)()
                n = BamWriter._ENC(sam, len(sam), names, buf, cap)
                if n >= 0:
                    break
                cap *= 2
            data = ctypes.string_at(buf, int(n))
        with span("dart.output.deflate"):
            self.bgzf.write(data)

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
