"""The port's fast readers (``dart_tpu_torch.io.fastx_fast``, whose byte
work is ``native/fastx.cpp``) on every input shape they take.

Each shape is held two ways: every ``BlobChunk`` field, chunk by chunk,
byte for byte against ``dart_tpu.io.fastx_fast`` (the NumPy readers the
native pass replaced), and each read's header, sequence, quality and
codes against the port's per-record ``io/fastx.py`` ``ChunkReader``,
chunk sizes included. Where the two references part ways the shape is
held to the NumPy reader's bytes alone: a header with more than three
leading markers (the NumPy reader skips at most three), a FASTA file
without a final newline (``ChunkReader`` drops the last base, as the
reference drops each line's last character). An empty file, which the
NumPy reader cannot open, is held to ``ChunkReader`` alone. Last, the
aligner's ``input_native_reads`` counter on a small run, native and not.
"""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest

from dart_tpu.io import fastx_fast as numpy_reader
from dart_tpu_torch import cli
from dart_tpu_torch.aligner import DartAligner
from dart_tpu_torch.io import fastx_fast
from dart_tpu_torch.io.fastx import ChunkReader
from dart_tpu_torch.index import load_index
from dart_tpu_torch.ops.fm_torch import FMIndexTorch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
TOY = os.path.join(HERE, "golden", "index", "toy")


def _rand_seq(rng, n, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].tobytes()


def _fastq(recs):
    return b"".join(b"@%s\n%s\n+\n%s\n" % r for r in recs)


def _write(path, data):
    path = str(path)
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(data)
    return path


def _pairs_fq(rng, n, lens, lower=False):
    """Two FASTQ files' records of n pairs with lengths drawn from lens;
    with lower, second mates in lower case with Ns and other bytes."""
    def rec(name, seq):
        return name, seq, _rand_seq(rng, len(seq), b"!#5?I")

    m1, m2 = [], []
    for i in range(n):
        a = _rand_seq(rng, int(rng.choice(lens)))
        b = _rand_seq(rng, int(rng.choice(lens)),
                      b"acgtnNRY" if lower else b"ACGT")
        m1.append(rec(b"p%d/1" % i, a))
        m2.append(rec(b"p%d/2" % i, b))
    return m1, m2


# A shape: name -> (files, pair_end, chunk_reads, ramp) written into a
# directory; a second file makes split-file pairs.
def _fq_single(d, rng):
    return [os.path.join(DATA, "se_mm.fq")], False, 7, False


def _fq_interleaved(d, rng):
    return [os.path.join(DATA, "pe_inter.fq")], True, 10, False


def _fq_split(d, rng):
    return [os.path.join(DATA, "pe_1.fq"), os.path.join(DATA, "pe_2.fq")], \
        True, 64, False


def _fa_single(d, rng):
    return [os.path.join(DATA, "se_exact.fa")], False, 7, False


def _fa_wrapped(d, rng):
    return [_write(d / "w.fa", b">r1 some comment\nACGTACGT\nGGTT\nA\n"
                   b">r2/2\nTTTT\n>r3\nacgtN\nNNAC\n>r4\n\nAC\n\nG\n")], \
        False, 2, False


def _fa_split(d, rng):
    def fa(mate):
        out = []
        for i in range(41):
            s = _rand_seq(rng, int(rng.integers(20, 200)), b"ACGTNacgt")
            lines = [s[k:k + 60] for k in range(0, len(s), 60)]
            out.append(b">f%d/%d\n" % (i, mate) + b"\n".join(lines) + b"\n")
        return b"".join(out)
    return [_write(d / "f_1.fa", fa(1)), _write(d / "f_2.fa", fa(2))], \
        True, 16, False


def _fa_interleaved_wrapped(d, rng):
    files, _, _, _ = _fa_split(d, rng)
    return files[:1], True, 12, False


def _fq_gz_split(d, rng):
    return [os.path.join(DATA, "pe_1.fq.gz"),
            os.path.join(DATA, "pe_2.fq.gz")], True, 64, False


def _fa_gz(d, rng):
    with open(os.path.join(DATA, "spliced.fa"), "rb") as f:
        return [_write(d / "s.fa.gz", f.read())], False, 50, False


def _mixed_lengths(d, rng):
    m1, m2 = _pairs_fq(rng, 57, [31, 76, 100, 151, 250])
    return [_write(d / "m_1.fq", _fastq(m1)), _write(d / "m_2.fq", _fastq(m2))], \
        True, 20, False


def _mixed_interleaved(d, rng):
    m1, m2 = _pairs_fq(rng, 33, [50, 99, 100, 101])
    recs = [r for pair in zip(m1, m2) for r in pair]
    return [_write(d / "mi.fq", _fastq(recs))], True, 9, False


def _headers(d, rng):
    heads = [b"@r1", b"@@r2", b"@>r3 x", b"@r4/1", b"@r5\tt", b"@r6 a/b",
             b"@", b"@@", b"@ lead", b"@/x", b"@r11\tx y/z"]
    recs = b"".join(h + b"\nACGTN\n+\nIIIII\n" for h in heads)
    return [_write(d / "h.fq", recs)], False, 4, False


def _headers_fa(d, rng):
    heads = [b">r1", b">>r2", b">@r3 x", b">r4/1", b">r5\tt", b">>>r6"]
    return [_write(d / "h.fa", b"".join(h + b"\nACGT\n" for h in heads))], \
        False, 3, False


def _many_markers(d, rng):
    return [_write(d / "mm.fq", b"@@@@r1 x\nACGT\n+\nIIII\n"
                   b"@>@>@r2\nACGA\n+\nIIII\n@r3\nAC\n+\nII\n")], \
        False, 8, False


def _long_quality(d, rng):
    recs = [(b"q%d" % i, _rand_seq(rng, 40), _rand_seq(rng, 40 + i % 7))
            for i in range(30)]
    return [_write(d / "lq_1.fq", _fastq(recs)),
            _write(d / "lq_2.fq", _fastq(recs[::-1]))], True, 8, False


def _no_final_newline_fq(d, rng):
    return [_write(d / "nf.fq", b"@a\nACGT\n+\nIIII\n@b\nTTGCA\n+\nIIIII")], \
        True, 4, False


def _no_final_newline_fa(d, rng):
    return [_write(d / "nf.fa", b">a\nACGT\nAC\n>b x\nTTGCA")], False, 4, False


def _empty(d, rng):
    return [_write(d / "e.fq", b"")], False, 4, False


def _long_reads(d, rng):
    def fq(tag):
        recs = []
        for i in range(40):
            s = _rand_seq(rng, int(rng.choice([5000, 20000, 120000])))
            recs.append((b"%s%d" % (tag, i), s, b"I" * len(s)))
        return _fastq(recs)
    return [_write(d / "l_1.fq", fq(b"a")), _write(d / "l_2.fq", fq(b"b"))], \
        True, 4000, False


def _long_reads_single(d, rng):
    files, _, chunk, _ = _long_reads(d, rng)
    return files[:1], False, chunk, False


def _ramp(d, rng):
    m1, m2 = _pairs_fq(rng, 2300, [100])
    return [_write(d / "r_1.fq", _fastq(m1)), _write(d / "r_2.fq", _fastq(m2))], \
        True, 8192, True


def _ramp_single(d, rng):
    m1, _ = _pairs_fq(rng, 4500, [100])
    return [_write(d / "rs.fq", _fastq(m1))], True, 9000, True


def _lower_n_mates(d, rng):
    m1, m2 = _pairs_fq(rng, 40, [60, 100], lower=True)
    return [_write(d / "n_1.fq", _fastq(m1)), _write(d / "n_2.fq", _fastq(m2))], \
        True, 16, False


def _lower_n_interleaved_fa(d, rng):
    m1, m2 = _pairs_fq(rng, 25, [70], lower=True)
    recs = b"".join(b">%s\n%s\n" % (r[0], r[1]) for p in zip(m1, m2) for r in p)
    return [_write(d / "n.fa", recs)], True, 10, False


BOTH = [_fq_single, _fq_interleaved, _fq_split, _fa_single, _fa_wrapped,
        _fa_split, _fa_interleaved_wrapped, _fq_gz_split, _fa_gz,
        _mixed_lengths, _mixed_interleaved, _headers, _headers_fa,
        _long_quality, _no_final_newline_fq, _long_reads,
        _long_reads_single, _ramp, _ramp_single, _lower_n_mates,
        _lower_n_interleaved_fa]
NUMPY_ONLY = [_many_markers, _no_final_newline_fa]
RECORDS_ONLY = [_empty]


def _ids(shapes):
    return [s.__name__.lstrip("_") for s in shapes]


def _open(mod, files, pair_end, chunk, ramp):
    if len(files) == 2:
        return mod.FastPairedReader(*files, chunk, ramp=ramp)
    return mod.FastChunkReader(files[0], pair_end, chunk, ramp=ramp)


def _chunks(reader):
    out = []
    while (c := reader.next_chunk()) is not None:
        out.append(c)
    reader.close()
    return out


def _records(files, pair_end, chunk, ramp):
    r = ChunkReader(files[0], files[1] if len(files) == 2 else None,
                    pair_end, chunk_reads=chunk, ramp=ramp)
    out = []
    while reads := r.next_chunk():
        out.append(reads)
    r.close()
    return out


@pytest.mark.parametrize("shape", BOTH + NUMPY_ONLY, ids=_ids(BOTH + NUMPY_ONLY))
def test_chunks_equal_the_numpy_reader(shape, tmp_path):
    args = shape(tmp_path, np.random.default_rng(17))
    new = _chunks(_open(fastx_fast, *args))
    old = _chunks(_open(numpy_reader, *args))
    assert new and len(new) == len(old)
    for c, o in zip(new, old):
        assert isinstance(c.seq_blob, bytes) and c.n == o.n
        assert c.fastq == o.fastq
        assert c.seq_blob == o.seq_blob and c.hdr_blob == o.hdr_blob
        # the NumPy reader gives split-file FASTA pairs a qual_blob of
        # None, every other FASTA chunk b""; the pipeline reads neither
        assert c.qual_blob == (o.qual_blob or b"")
        for f in ("seq_off", "hdr_off", "qual_off"):
            a, b = getattr(c, f), getattr(o, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype == np.int64
                np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("shape", BOTH + RECORDS_ONLY,
                         ids=_ids(BOTH + RECORDS_ONLY))
def test_reads_equal_the_record_reader(shape, tmp_path):
    args = shape(tmp_path, np.random.default_rng(17))
    new = _chunks(_open(fastx_fast, *args))
    ref = _records(*args)
    assert [len(c) for c in new] == [len(c) for c in ref]
    for c, reads in zip(new, ref):
        codes, rlens = c.codes_matrix()
        for i, read in enumerate(reads):
            assert c.header(i) == read.header
            assert c.seq(i) == read.seq
            if c.fastq:
                assert c.qual_blob[c.qual_off[i]:c.qual_off[i + 1]] == read.qual
            assert rlens[i] == read.rlen
            np.testing.assert_array_equal(codes[i, :read.rlen], read.codes)


def test_the_references_part_ways_where_said(tmp_path):
    """The NUMPY_ONLY shapes are where the two references differ (so the
    native pass keeps the NumPy reader's bytes there)."""
    rng = np.random.default_rng(17)
    for shape in NUMPY_ONLY:
        args = shape(tmp_path, rng)
        new = _chunks(_open(fastx_fast, *args))
        flat = [(c.header(i), c.seq(i)) for c in new for i in range(c.n)]
        ref = [(r.header, r.seq) for reads in _records(*args) for r in reads]
        assert flat != ref, shape.__name__


def test_a_short_quality_stays_with_its_read(tmp_path):
    """A quality line shorter than its sequence gives that read its own
    bytes, reversed in a second mate; the NumPy reader's fixed-length
    path reversed the sequence's length of qualities there and took the
    next mate's bytes (and ChunkReader keeps the newline)."""
    path = _write(tmp_path / "sq.fq", b"@a\nACGT\n+\nIIII\n@b\nACGT\n+\nAB\n"
                  b"@c\nACGT\n+\nIIII\n@d\nACGT\n+\nCDEF\n")
    c = fastx_fast.FastChunkReader(path, True, 8).next_chunk()
    quals = [c.qual_blob[c.qual_off[i]:c.qual_off[i + 1]] for i in range(4)]
    assert quals == [b"IIII", b"BA", b"IIII", b"FEDC"]
    assert [c.seq(i) for i in range(4)] == [b"ACGT"] * 4  # ACGT's revcomp


@pytest.mark.parametrize("native", [True, False], ids=["native", "records"])
def test_native_reads_counter(native, tmp_path):
    """stats["input_native_reads"] counts every read of a run that the
    native pass emitted: all of them, or none through ChunkReader."""
    files = []
    for mate in (1, 2):  # the first 48 pairs of the toy set
        with open(os.path.join(DATA, f"pe_{mate}.fq"), "rb") as f:
            head = b"".join(f.readlines()[:4 * 48])
        files.append(_write(tmp_path / f"pe_{mate}.fq", head))
    argv = ["-i", TOY, "-f", files[0], "-f2", files[1],
            "-o", str(tmp_path / "o.sam"), "-j", str(tmp_path / "o.tab"),
            "-silent", "--batch", "32"]
    cfg = cli.parse_args(argv + ([] if native else ["--no-native"]))
    idx = load_index(TOY)
    aligner = DartAligner(idx, cfg, engine=FMIndexTorch(idx, "cpu"))
    with contextlib.redirect_stdout(io.StringIO()):
        aligner.run()
    assert aligner.counters["total"] == 96
    assert aligner.stats["input_native_reads"] == (96 if native else 0)
