"""The plain reference that decides ``correct``: it replays every record
the window wrote against the genome and the reads the benchmark made.

It imports NumPy and the standard library alone: nothing of the
program, whose outputs it only reads to judge them. It takes the
genome's bases (``genomes.make_genome``), the pool's reads and origins
(``reads.make_pool``), the records (SAM text, or BAM decoded here) and
the ``junctions.tab`` rows, and gives these numbers:

- ``reads_missing``: read occurrences of the window (each read once
  for each time its file was listed) without exactly one primary
  record, and primary records of reads that were not sent;
- ``records_wrong``: records that do not parse, whose SEQ is not the
  read (reverse complemented on the reverse strand; an unmapped record
  may carry either), whose CIGAR is malformed (an operation outside
  MIDNS, a clip inside, query bases other than the read's length), or
  whose bases fall outside their chromosome;
- ``mates_wrong``: pairs whose mate fields disagree with the mates'
  own records: flags 0x1 on both, 0x40 on mate 1 alone and 0x80 on
  mate 2 alone; RNEXT ``=`` with a PNEXT and no 0x8, or ``*`` with
  PNEXT and TLEN 0; where both name each other with ``=``, the same
  chromosome, each PNEXT the other's POS and TLENs of opposite sign;
- ``nm_off_ppm``: mapped records whose NM is not their replayed edits
  (bases of an M that differ from the genome, plus inserted bases; the
  aligner does not count deleted bases), either way, per million
  mapped records judged;
- ``unplaced_pct``: the share of read occurrences, in %, whose primary
  record does not lie at its origin (100 less ``placed_pct``);
- ``sj_rows_off``: junctions (chromosome, first and last intron base,
  1-based) whose count in ``junctions.tab`` lies outside what the
  counted records allow: at most the counted records whose CIGAR has
  that N, and at least those among them with no other N. Counted:
  primary, MAPQ 50 (any mapped primary with ``-all_sj``), marked with
  XS:A, each N longer than the least intron. The aligner counts a
  junction where its seeds meet at a splice site it recognises, which
  a read's only junction always is, and a read's other junctions need
  not be;
- ``placed_pct`` (a metric, not a number compared): the share of read
  occurrences whose primary record lies at its origin (FluxEva's rule:
  the read's chromosome, POS within its first and last genome base;
  MAPQ 0 and unmapped count as not placed).

Records are judged in segments (the chunks a SAM run wrote, or a BAM's
records cut at the read files' bounds), each with the number of times
it was written: a segment written again byte for byte gets the same
verdict, so each distinct one is judged once. Both parsers, and the
replay, work on whole arrays.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

MAX_MAPQ = 50
BAM_OPS = b"MIDNSHP=X"
BAM_BASES = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[np.frombuffer(b"ACGTN", dtype=np.uint8)] = np.frombuffer(
    b"TGCAN", dtype=np.uint8)
NUMBERS = ("reads_missing", "records_wrong", "mates_wrong", "nm_off_ppm",
           "unplaced_pct", "sj_rows_off")
PAD = 64  # bytes of zeros after a buffer, so that windows never run off it
RNEXT_SAME, RNEXT_NONE, UNKNOWN = -2, -1, -3


def _windows(buf: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Rows buf[s:s + width] for each start (buf padded by PAD)."""
    return np.lib.stride_tricks.sliding_window_view(buf, width)[starts]


def _ints(buf: np.ndarray, s: np.ndarray, e: np.ndarray,
          width: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """The decimal integers buf[s:e] (an optional leading '-'): (values,
    whether each parsed)."""
    n = e - s
    win = _windows(buf, s, width).astype(np.int64)
    neg = win[:, 0] == ord("-")
    val = np.zeros(s.shape[0], dtype=np.int64)
    ok = (n >= 1) & (n <= width) & (n > neg)
    for j in range(width):
        use = (j < n) & ~((j == 0) & neg)
        d = win[:, j] - 48
        ok &= ~use | ((d >= 0) & (d <= 9))
        val = np.where(use, val * 10 + d, val)
    return np.where(neg, -val, val), ok


class Records:
    """A segment's records as arrays of length ``n``: ``ok`` (parsed),
    ``rid`` (the read's number in its name, -1 if none), ``flag``,
    ``chrom`` (index into the genome's names; -1 for ``*``, -3 unknown),
    ``pos``, ``mapq``, ``rnext`` (a chromosome's index; -2 for ``=``,
    -1 for ``*``), ``pnext``, ``tlen``, ``nm`` (-1 where absent),
    ``xs_a``, ``seq`` ((n, read length) uint8; ``seq_ok``: SEQ had
    that length), ``plain`` (the CIGAR is ``<read length>M``), and for
    the others their operations in record order (``op_rec``, the
    record; ``op_code``, an index into ``MIDNSHP=X``; ``op_len``) and
    ``cig_bad`` (the CIGAR does not parse)."""

    INTS = ("rid", "flag", "chrom", "pos", "mapq", "rnext", "pnext", "tlen",
            "nm")

    def __init__(self, n: int, rl: int):
        self.n = n
        for k in self.INTS:
            setattr(self, k, np.full(n, -1, dtype=np.int64))
        self.ok = np.zeros(n, dtype=bool)
        self.xs_a = np.zeros(n, dtype=bool)
        self.plain = np.zeros(n, dtype=bool)
        self.seq_ok = np.zeros(n, dtype=bool)
        self.seq = np.zeros((n, rl), dtype=np.uint8)
        self.cig_bad = np.zeros(n, dtype=bool)
        self.op_rec = self.op_code = self.op_len = np.zeros(0, dtype=np.int64)


def _names(buf, s, e, chrom_ix: dict) -> np.ndarray:
    """Each field buf[s:e] as a chromosome's index, -2 for ``=``, -1 for
    ``*``, -3 for anything else."""
    out = np.full(s.shape[0], UNKNOWN, dtype=np.int64)
    n = e - s
    one = buf[s]
    out[(n == 1) & (one == ord("*"))] = RNEXT_NONE
    out[(n == 1) & (one == ord("="))] = RNEXT_SAME
    for name, ix in chrom_ix.items():
        want = np.frombuffer(name, dtype=np.uint8)
        hit = (n == want.shape[0]) & (_windows(buf, s, want.shape[0])
                                      == want).all(1)
        out[hit] = ix
    return out


def parse_sam(text: bytes, chrom_ix: dict, rl: int) -> Records:
    """The records of SAM text (header lines skipped)."""
    buf = np.frombuffer(text + b"\n" + bytes(PAD), dtype=np.uint8)
    size = len(text) + 1
    ends = np.flatnonzero(buf[:size] == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    keep = (ends > starts) & (buf[starts] != ord("@"))
    starts, ends = starts[keep], ends[keep]
    r = Records(starts.shape[0], rl)
    if r.n == 0:
        return r
    tabs = np.append(np.flatnonzero(buf[:size] == 9), size)
    first = np.searchsorted(tabs, starts)
    ntab = np.searchsorted(tabs, ends) - first
    r.ok = ntab >= 10

    def field(k):
        s = starts if k == 0 else tabs[np.minimum(first + k - 1,
                                                  tabs.shape[0] - 1)] + 1
        e = np.where(k < ntab, tabs[np.minimum(first + k,
                                               tabs.shape[0] - 1)], ends)
        return np.minimum(s, ends), np.minimum(e, ends)

    s0, _ = field(0)
    rid, ok = _ints(buf, s0 + 1, s0 + 10, 9)
    r.rid = np.where(ok & (buf[s0] == ord("r")), rid, -1)
    for k, name, width in ((1, "flag", 6), (3, "pos", 11), (4, "mapq", 4),
                           (7, "pnext", 11), (8, "tlen", 12)):
        v, ok = _ints(buf, *field(k), width)
        setattr(r, name, v)
        r.ok &= ok
    r.chrom = _names(buf, *field(2), chrom_ix)
    r.chrom[r.chrom == RNEXT_SAME] = UNKNOWN
    r.rnext = _names(buf, *field(6), chrom_ix)
    s, e = field(5)
    plain = np.frombuffer(b"%dM" % rl, dtype=np.uint8)
    r.plain = (e - s == plain.shape[0]) & (
        _windows(buf, s, plain.shape[0]) == plain).all(1)
    _sam_ops(r, buf, s, e)
    s, e = field(9)
    r.seq_ok = e - s == rl
    r.seq = _windows(buf, s, rl).copy()
    s, e = field(11)
    tag = (ntab >= 11) & (_windows(buf, s, 5) == np.frombuffer(
        b"NM:i:", dtype=np.uint8)).all(1)
    nm, ok = _ints(buf, s + 5, e, 6)
    r.nm = np.where(tag & ok, nm, -1)
    last = np.maximum(ends - 7, starts)
    r.xs_a = (_windows(buf, last, 6) == np.frombuffer(
        b" XS:A:", dtype=np.uint8)).all(1)
    return r


OP_CODE = np.full(256, -1, dtype=np.int64)
OP_CODE[np.frombuffer(BAM_OPS, dtype=np.uint8)] = np.arange(len(BAM_OPS))


def _sam_ops(r: Records, buf, s, e) -> None:
    """The operations of the CIGARs buf[s:e] of the records that are not
    plain, read all at once."""
    idx = np.flatnonzero(~r.plain & r.ok)
    ln = (e - s)[idx]
    total = int(ln.sum())
    if total == 0:
        r.cig_bad[idx] = True
        return
    at = np.repeat(s[idx] - (np.cumsum(ln) - ln), ln) + np.arange(total)
    text = np.concatenate([buf[at], np.zeros(PAD, dtype=np.uint8)])
    owner = np.repeat(idx, ln)
    code = OP_CODE[text[:total]]
    digit = (text[:total] >= 48) & (text[:total] <= 57)
    bad = np.zeros(r.n, dtype=bool)
    bad[owner[~digit & (code < 0)]] = True
    bad[idx[ln == 0]] = True
    last = np.cumsum(ln) - 1
    bad[idx[(ln > 0) & (code[np.maximum(last, 0)] < 0)]] = True
    p = np.flatnonzero(code >= 0)
    rec = owner[p]
    begin = np.empty_like(p)
    begin[1:] = p[:-1] + 1
    begin[:1] = 0
    new = np.ones(p.shape[0], dtype=bool)
    new[1:] = rec[1:] != rec[:-1]
    first_byte = np.cumsum(ln) - ln  # each record's first byte
    row = np.searchsorted(idx, rec)
    begin = np.where(new, first_byte[row], begin)
    val, ok = _ints(text, begin, p, 10)
    bad[rec[~ok]] = True
    r.cig_bad = bad
    r.op_rec, r.op_code, r.op_len = rec, code[p], val


def bam_blob(path: str) -> tuple[bytes, list, int]:
    """A BAM file decompressed: (bytes, reference names, offset of its
    first record)."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM stream")
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    names = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", data, off)[0]
        names.append(data[off + 4:off + 4 + ln - 1])
        off += 8 + ln
    return data, names, off


def bam_offsets(data: bytes, off: int) -> list:
    """Each record's offset in a decompressed BAM, and the end."""
    out = []
    size = len(data)
    unpack = struct.unpack_from
    while off + 4 <= size:
        out.append(off)
        off += 4 + unpack("<i", data, off)[0]
    out.append(min(off, size))
    return out


def _le(win: np.ndarray, lo: int, width: int, signed: bool) -> np.ndarray:
    """Little-endian integers of ``width`` bytes at column ``lo`` of the
    rows ``win``."""
    v = np.zeros(win.shape[0], dtype=np.int64)
    for j in range(width - 1, -1, -1):
        v = (v << 8) | win[:, lo + j].astype(np.int64)
    if signed:
        top = 1 << (8 * width - 1)
        v = np.where(v >= top, v - 2 * top, v)
    return v


def parse_bam(data: bytes, offs: list, ref_names: list, chrom_ix: dict,
              rl: int) -> Records:
    """BAM records data[offs[0]:offs[-1]] as ``Records``."""
    a = np.asarray(offs[:-1], dtype=np.int64)
    end = np.asarray(offs[1:], dtype=np.int64)
    r = Records(a.shape[0], rl)
    if r.n == 0:
        return r
    buf = np.frombuffer(data + bytes(PAD + 2 * rl), dtype=np.uint8)
    core = _windows(buf, a, 36)
    ref, pos = _le(core, 4, 4, True), _le(core, 8, 4, True)
    l_name, r.mapq = core[:, 12].astype(np.int64), core[:, 13].astype(
        np.int64)
    n_cig, r.flag = _le(core, 16, 2, False), _le(core, 18, 2, False)
    l_seq = _le(core, 20, 4, True)
    nref, npos, r.tlen = (_le(core, 24, 4, True), _le(core, 28, 4, True),
                          _le(core, 32, 4, True))
    ix = np.array([chrom_ix.get(n, UNKNOWN) for n in ref_names] + [-1],
                  dtype=np.int64)
    r.chrom = np.where(ref >= 0, ix[np.minimum(ref, len(ref_names))], -1)
    r.pos, r.pnext = pos + 1, npos + 1
    r.rnext = np.where(nref < 0, RNEXT_NONE, np.where(
        nref == ref, RNEXT_SAME, ix[np.clip(nref, 0, len(ref_names))]))
    name = a + 36
    rid, ok = _ints(buf, name + 1, name + 10)
    r.rid = np.where(ok & (buf[name] == ord("r")), rid, -1)
    cig = name + l_name
    op0 = _le(_windows(buf, cig, 4), 0, 4, False)
    r.plain = (n_cig == 1) & (op0 == rl << 4)
    q = cig + 4 * n_cig
    half = (rl + 1) // 2
    packed = _windows(buf, q, half)
    bases = np.empty((r.n, 2 * half), dtype=np.uint8)
    bases[:, 0::2], bases[:, 1::2] = BAM_BASES[packed >> 4], \
        BAM_BASES[packed & 15]
    r.seq = bases[:, :rl].copy()
    r.seq_ok = l_seq == rl
    t = q + (l_seq + 1) // 2 + l_seq
    head = _windows(buf, t, 7)
    is_nm = (head[:, 0] == ord("N")) & (head[:, 1] == ord("M"))
    typ = head[:, 2]
    nm = np.select([typ == ord("C"), typ == ord("c"), typ == ord("S"),
                    typ == ord("s"), typ == ord("I"), typ == ord("i")],
                   [_le(head, 3, 1, False), _le(head, 3, 1, True),
                    _le(head, 3, 2, False), _le(head, 3, 2, True),
                    _le(head, 3, 4, False), _le(head, 3, 4, True)], -1)
    r.nm = np.where(is_nm, nm, -1)
    r.xs_a = (_windows(buf, end - 4, 3) == np.frombuffer(
        b"XSA", dtype=np.uint8)).all(1)
    r.ok = (t <= end) & (end - a >= 36) & (l_seq >= 0)
    idx = np.flatnonzero(~r.plain & r.ok)
    k = n_cig[idx]
    r.cig_bad[idx[k == 0]] = True
    at = np.repeat(cig[idx] - 4 * (np.cumsum(k) - k), k) + 4 * np.arange(
        int(k.sum()))
    v = _le(_windows(buf, at, 4), 0, 4, False)
    r.op_rec, r.op_code, r.op_len = np.repeat(idx, k), v & 15, v >> 4
    r.cig_bad[r.op_rec[r.op_code >= len(BAM_OPS)]] = True
    return r


def _cigar(r: Records, i: int) -> str:
    """Record i's CIGAR, written out again from its operations."""
    if r.plain[i]:
        return "%dM" % r.seq.shape[1]
    k = r.op_rec == i
    return "".join(f"{n}{chr(BAM_OPS[c])}" for n, c in
                   zip(r.op_len[k].tolist(), r.op_code[k].tolist()))


class Reference:
    """The genome and pool a run was made from, and what a run of them
    should give. ``genome``: ``names`` and ``seqs`` (uint8 ASCII);
    ``pool``: ``seq`` (mates), ``chrom``, ``left``, ``right``;
    ``file_fragments``: fragments a pool file; ``paired``;
    ``min_intron``, ``all_sj``: the flags' values."""

    def __init__(self, genome, pool, file_fragments: int, paired: bool,
                 min_intron: int = 5, all_sj: bool = False):
        self.names = list(genome.names)
        self.chrom_ix = {n.encode(): i for i, n in enumerate(self.names)}
        self.lens = np.array([genome.seqs[n].shape[0] for n in self.names],
                             dtype=np.int64)
        self.offset = np.concatenate([[0], np.cumsum(self.lens)[:-1]])
        self.text = np.concatenate([genome.seqs[n] for n in self.names]
                                   + [np.zeros(PAD, dtype=np.uint8)])
        self.pool = pool
        self.per = int(file_fragments)
        self.paired = paired
        self.mates = 2 if paired else 1
        self.rl = int(pool.seq[0].shape[1])
        self.min_intron = min_intron
        self.all_sj = all_sj
        self.counts = np.zeros(pool.n * self.mates, dtype=np.int64)
        self.placed = 0
        self.sj: dict = {}
        self.out = dict.fromkeys(NUMBERS, 0)
        self.n_records = 0
        self.nm_off = self.nm_judged = 0
        self.nm_off_seen: list = []  # a few of those records, to show

    def judge(self, r: Records, mult: int) -> None:
        """Judge a segment's records, written ``mult`` times."""
        if r.n == 0:
            return
        self.n_records += r.n * mult
        mate = ((r.flag & 0x80) != 0).astype(np.int64) if self.paired else \
            np.zeros(r.n, dtype=np.int64)
        known = r.ok & (r.rid >= 0) & (r.rid < self.pool.n)
        primary = (r.flag & 0x900) == 0
        mapped = (r.flag & 4) == 0
        key = np.where(known, r.rid * self.mates + mate, 0)
        np.add.at(self.counts, key[known & primary], mult)
        self.out["reads_missing"] += int((~known & primary).sum()) * mult
        wrong = ~known | self._seq_wrong(r, mate, known, mapped)
        wrong |= self._replay(r, known & mapped & ~wrong)
        judged, edits = self._edits
        self.nm_judged += int(judged.sum()) * mult
        off = np.flatnonzero(judged & (edits != r.nm))
        self.nm_off += off.shape[0] * mult
        for i in off[:max(0, 3 - len(self.nm_off_seen))].tolist():
            self.nm_off_seen.append(
                f"r{r.rid[i]} flag {r.flag[i]} pos {r.pos[i]} "
                f"{_cigar(r, i)} NM {r.nm[i]}, {edits[i]} replayed")
        self.out["records_wrong"] += int(wrong.sum()) * mult
        good = known & primary & mapped & ~wrong
        self._placed(r, mate, good & (r.mapq > 0), mult)
        self._junctions(r, good, mult)
        if self.paired:
            self.out["mates_wrong"] += self._mates(r, known & primary) * mult

    def _seq_wrong(self, r, mate, known, mapped) -> np.ndarray:
        rid = np.where(known, r.rid, 0)
        read = np.where((mate == 1)[:, None], self.pool.seq[-1][rid],
                        self.pool.seq[0][rid])
        fwd = (r.seq == read).all(1)
        rev = (r.seq == COMP[read[:, ::-1]]).all(1)
        ok = np.where(mapped, np.where((r.flag & 16) != 0, rev, fwd),
                      fwd | rev)
        return ~(ok & r.seq_ok)

    def _replay(self, r, todo) -> np.ndarray:
        """Replay the CIGARs of records ``todo`` against the genome:
        returns the malformed, and keeps the others' replayed edits in
        ``_edits`` (which records, and their edits)."""
        rl = self.rl
        M, I, D, N, S = range(5)
        rec, code, ln = r.op_rec, r.op_code, r.op_len
        keep = todo[rec] & ~r.plain[rec]
        rec, code, ln = rec[keep], code[keep], ln[keep]
        new = np.ones(rec.shape[0], dtype=bool)
        new[1:] = rec[1:] != rec[:-1]
        end = np.ones(rec.shape[0], dtype=bool)
        end[:-1] = rec[1:] != rec[:-1]
        wrong = (code > S) | ((code == S) & ~new & ~end)
        q = np.where(np.isin(code, (M, I, S)), ln, 0)
        g = np.where(np.isin(code, (M, D, N)), ln, 0)
        bad = r.cig_bad | (todo & ~r.plain & (np.bincount(
            rec, weights=q, minlength=r.n) != rl))
        bad[rec[wrong]] = True
        span = np.where(r.plain, rl, np.bincount(rec, weights=g,
                                                 minlength=r.n)
                        ).astype(np.int64)
        ins = np.bincount(rec, weights=np.where(code == I, ln, 0),
                          minlength=r.n).astype(np.int64)
        c = np.maximum(r.chrom, 0)
        bad = todo & (bad | (r.chrom < 0) | (r.pos < 1) | (r.nm < 0)
                      | (r.pos - 1 + span > self.lens[c]))
        ok = todo & ~bad
        # each operation's offsets in its read and in the genome
        first = np.maximum.accumulate(np.where(new, np.arange(rec.shape[0]),
                                               0))
        cq, cg = np.cumsum(q) - q, np.cumsum(g) - g
        q_off, g_off = cq - cq[first], cg - cg[first]
        mism = np.zeros(r.n, dtype=np.int64)
        p = np.flatnonzero(ok & r.plain)
        at = self.offset[c[p]] + r.pos[p] - 1
        mism[p] = (_windows(self.text, at, rl) != r.seq[p]).sum(1)
        m = (code == M) & ok[rec]
        mrec, mq, mg, mlen = rec[m], q_off[m], g_off[m], ln[m]
        if mrec.shape[0]:
            o = np.repeat(np.arange(mrec.shape[0]), mlen)
            within = np.arange(o.shape[0]) - np.repeat(
                np.cumsum(mlen) - mlen, mlen)
            x = mrec[o]
            at = self.offset[c[x]] + r.pos[x] - 1 + mg[o] + within
            diff = self.text[at] != r.seq[x, mq[o] + within]
            mism += np.bincount(x, weights=diff,
                                minlength=r.n).astype(np.int64)
        self._edits = (ok, mism + ins)
        # the N operations, for the junctions
        n = (code == N) & ok[rec]
        self._n_ops = (rec[n], r.pos[rec[n]] + g_off[n], ln[n])
        return bad

    def _placed(self, r, mate, sel, mult) -> None:
        i = np.flatnonzero(sel)
        rid, m = r.rid[i], mate[i]
        at = ((r.chrom[i] == self.pool.chrom[rid])
              & (self.pool.left[rid, m] <= r.pos[i])
              & (r.pos[i] <= self.pool.right[rid, m]))
        self.placed += int(at.sum()) * mult

    def _junctions(self, r, good, mult) -> None:
        counted = good & r.xs_a & ~r.plain
        if not self.all_sj:
            counted &= r.mapq == MAX_MAPQ
        rec, start, ln = self._n_ops
        sel = counted[rec] & (ln - 1 >= self.min_intron)
        rec, start, ln = rec[sel], start[sel], ln[sel]
        if rec.shape[0] == 0:
            return
        only = np.bincount(rec, minlength=r.n)[rec] == 1
        keys, inv = np.unique(np.stack([r.chrom[rec], start,
                                        start + ln - 1], axis=1),
                              axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        hi = np.bincount(inv) * mult
        lo = np.bincount(inv, weights=only).astype(np.int64) * mult
        for k, a, b in zip(map(tuple, keys.tolist()), lo.tolist(),
                           hi.tolist()):
            x, y = self.sj.get(k, (0, 0))
            self.sj[k] = (x + a, y + b)

    def _mates(self, r, sel) -> int:
        """Pairs among the primary records ``sel`` whose mate fields
        disagree; a read of a pair whose mate has no primary record here
        is counted under reads_missing."""
        i = np.flatnonzero(sel)
        order = np.lexsort(((r.flag[i] & 0x80) != 0, r.rid[i]))
        i = i[order]
        pair = (r.rid[i][:-1] == r.rid[i][1:]) & ((r.flag[i][:-1] & 0x80)
                                                  == 0)
        a = i[:-1][pair]
        b = i[1:][pair]
        fa, fb = r.flag[a], r.flag[b]
        wrong = ((fa & 0xC1) != 0x41) | ((fb & 0xC1) != 0x81)
        # RNEXT is "=" where the record's alignment has a mate (then PNEXT
        # and TLEN are set and 0x8 is not), else "*" with PNEXT and TLEN
        # 0; where both mates name each other, each PNEXT is the other's
        # POS. (0x8 and 0x20 say what the record's own pairing found, as
        # the reference aligner sets them, not what the mate's record
        # holds, so they are not held to it.)
        ea, eb = r.rnext[a] == RNEXT_SAME, r.rnext[b] == RNEXT_SAME
        for e, x in ((ea, a), (eb, b)):
            wrong |= ~e & ((r.rnext[x] != RNEXT_NONE) | (r.pnext[x] != 0)
                           | (r.tlen[x] != 0))
        wrong |= (ea & ((fa & 8) != 0)) | (eb & ((fb & 8) != 0))
        wrong |= ea & eb & ((r.pnext[a] != r.pos[b]) | (r.pnext[b] != r.pos[a])
                            | (r.tlen[a] != -r.tlen[b])
                            | (r.chrom[a] != r.chrom[b]))
        return int(wrong.sum())

    def finish(self, file_copies: list, tab_rows: list) -> dict:
        """The numbers, once every segment is judged. ``file_copies``:
        how many times each pool file was listed; ``tab_rows``:
        ``junctions.tab`` as (chromosome, start, end, count)."""
        want = np.repeat(np.asarray(file_copies, dtype=np.int64),
                         self.per * self.mates)
        self.out["reads_missing"] += int(np.abs(self.counts - want).sum())
        tab = {}
        for name, a, b, n in tab_rows:
            k = (self.chrom_ix.get(name.encode(), UNKNOWN), int(a), int(b))
            tab[k] = tab.get(k, 0) + int(n)
        self.out["sj_rows_off"] = sum(
            1 for k in set(tab) | set(self.sj)
            if not (self.sj.get(k, (0, 0))[0] <= tab.get(k, 0)
                    <= self.sj.get(k, (0, 0))[1]))
        total = int(want.sum())
        res = dict(self.out)
        res["placed_pct"] = 100.0 * self.placed / total if total else 0.0
        res["unplaced_pct"] = 100.0 - res["placed_pct"]
        res["nm_off_ppm"] = 1e6 * self.nm_off / self.nm_judged \
            if self.nm_judged else 0.0
        res["reads"] = total
        res["records"] = self.n_records
        res["sj_rows"] = len(tab)
        res["nm_off_seen"] = self.nm_off_seen
        return res


def read_tab(path: str) -> list:
    """``junctions.tab`` rows as (chromosome, start, end, count)."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                rows.append((p[0], int(p[1]), int(p[2]), int(p[3])))
    return rows
