"""The BAM writer's native paths held byte for byte to their Python twins:
``BgzfWriter``'s full blocks, deflated by ``native/bgzf.cpp`` on the
``-t`` threads, against a writer built from ``_deflate_block`` alone;
``dart_sam_to_bam_mt``, the encoder cut into ranges at line starts,
against one serial ``dart_sam_to_bam`` call; ``BamWriter`` with and
without its native entries; the library built where zlib is missing;
the aligner's byte counters and the benchmark's reader of them."""

import ctypes
import glob
import importlib.util
import json
import os
import random

import pytest

from dart_tpu_torch.io import bam
from dart_tpu_torch.native import build as native_build

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_SAMS = sorted(glob.glob(os.path.join(HERE, "golden", "c*.sam")))
B = bam.BgzfWriter.MAX_BLOCK
LEVELS = (0, 1, 6, 9)
THREADS = (1, 2, 4, 7)


def python_bgzf(writes, level, flush_after=()):
    """The BGZF stream of ``writes`` as BgzfWriter cuts it: a member for
    every full MAX_BLOCK bytes, the tail flushed as a short member after
    the writes whose index is in ``flush_after`` and at the end, then the
    EOF marker."""
    tail, out = b"", []
    for i, data in enumerate(writes):
        tail += data
        while len(tail) >= B:
            out.append(bam._deflate_block(tail[:B], level))
            tail = tail[B:]
        if i in flush_after and tail:
            out.append(bam._deflate_block(tail, level))
            tail = b""
    if tail:
        out.append(bam._deflate_block(tail, level))
    return b"".join(out) + bam.BGZF_EOF


def payload(n, seed=7):
    """``n`` bytes that deflate does some work on: runs over a small
    alphabet with noise, as BAM records are."""
    rng = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([rng.choice(b"ACGT")]) * rng.randrange(1, 12)
        out += rng.randbytes(rng.randrange(0, 4))
    return bytes(out[:n])


SHAPES = {
    "empty": [b""],
    "one_byte": [b"x"],
    "one_block": [payload(B)],
    "block_and_a_byte": [payload(B + 1)],
    "blocks_in_one_write": [payload(3 * B + 17)],
    "tails_across_writes": [payload(n, seed=n) for n in
                            (B - 5, 3, 0, 2, B // 2, B // 2 + 1, 1, 2 * B + 9)],
}


def native():
    n = bam._native()
    assert n.encode is not None and n.deflate is not None, (
        "the native library with its BGZF deflate is built here")
    return n


def write_all(path, writes, level, threads, **kw):
    w = bam.BgzfWriter(str(path), threads=threads, level=level, **kw)
    for data in writes:
        w.write(data)
    w.close()
    return w


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_writes_equal_the_python_writer(shape, threads, tmp_path):
    """Every write shape at level 1: the same bytes as the Python
    writer, and every full block deflated natively."""
    native()
    writes = SHAPES[shape]
    w = write_all(tmp_path / "a.bgzf", writes, 1, threads)
    total = sum(map(len, writes))
    assert (tmp_path / "a.bgzf").read_bytes() == python_bgzf(writes, 1)
    assert w.deflated_bytes == total
    assert w.native_bytes == total // B * B


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("level", LEVELS)
def test_levels_equal_the_python_writer(level, threads, tmp_path):
    """Every level at every thread count, on many blocks with tails
    carried between writes (at level 0 the stored blocks' lengths follow
    the room each deflate call is given)."""
    native()
    writes = SHAPES["tails_across_writes"] + [payload(5 * B + 3, seed=3)]
    write_all(tmp_path / "a.bgzf", writes, level, threads)
    assert (tmp_path / "a.bgzf").read_bytes() == python_bgzf(writes, level)


@pytest.mark.parametrize("threads", (1, 4))
def test_flush_boundary_then_append_resume(threads, tmp_path):
    """A flush mid-stream gives a member boundary; a file cut there and
    reopened with append=True ends as the stream with that flush."""
    native()
    writes = [payload(n, seed=n) for n in (B + 100, 2 * B + 3, 700, B)]
    path = tmp_path / "a.bgzf"
    w = bam.BgzfWriter(str(path), threads=threads)
    for data in writes[:2]:
        w.write(data)
    off = w.flush_boundary()
    w.write(writes[2])  # lost in the crash below
    w.fh.flush()
    w.fh.close()
    with open(path, "r+b") as f:
        f.truncate(off)
    w = bam.BgzfWriter(str(path), append=True, threads=threads)
    for data in writes[2:]:
        w.write(data)
    w.close()
    assert path.read_bytes() == python_bgzf(writes, 1, flush_after={1})


def test_deflate_refuses_a_short_buffer():
    """Room for fewer members than blocks is refused, not overrun."""
    n = native()
    src = payload(2 * B)
    out = ctypes.create_string_buffer(2 * bam.BgzfWriter.MAX_MEMBER)
    assert n.deflate(src, 2, 1, 2, ctypes.addressof(out),
                     2 * bam.BgzfWriter.MAX_MEMBER - 1) == -1
    m = n.deflate(src, 2, 1, 2, ctypes.addressof(out), len(out))
    assert out.raw[:m] == b"".join(bam._deflate_block(src[i * B:(i + 1) * B])
                                   for i in range(2))


def ref_names(sam):
    return b"".join(line.split(b"\t")[1][3:] + b"\n"
                    for line in sam.splitlines() if line.startswith(b"@SQ"))


def serial_encode(sam, names):
    lib = native_build.load()
    lib.dart_sam_to_bam.restype = ctypes.c_int64
    lib.dart_sam_to_bam.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64]
    cap = 2 * len(sam) + 4096
    out = ctypes.create_string_buffer(cap)
    n = lib.dart_sam_to_bam(sam, len(sam), names, ctypes.addressof(out), cap)
    assert n >= 0
    return out.raw[:n]


def range_encode(sam, names, threads, cap=None):
    cap = 2 * len(sam) + 4096 if cap is None else cap
    out = ctypes.create_string_buffer(max(cap, 1))
    n = native().encode(sam, len(sam), names, ctypes.addressof(out), cap,
                        threads)
    return None if n < 0 else out.raw[:n]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("sam_path", GOLDEN_SAMS,
                         ids=[os.path.basename(p) for p in GOLDEN_SAMS])
def test_range_encoder_equals_one_serial_call(sam_path, threads):
    """The golden SAMs, and pieces of them whose ranges hold only '@'
    lines (the header and one record), no record (one line, or none),
    or end without a newline."""
    sam = open(sam_path, "rb").read()
    names = ref_names(sam)
    head = sam[:sam.index(b"\n", sam.rindex(b"\n@") + 1) + 1]
    first = sam[len(head):sam.index(b"\n", len(head)) + 1]
    pieces = [sam, head + first, head, first, first[:-1], b"", b"\n\n",
              sam[:len(sam) // 3], sam[len(sam) // 3:]]
    for piece in pieces:
        assert range_encode(piece, names, threads) == \
            serial_encode(piece, names), piece[:80]
    assert range_encode(head + first, names, threads)  # one record


@pytest.mark.parametrize("threads", THREADS)
def test_range_encoder_refuses_a_short_buffer(threads):
    """A buffer too small for some range's records gives -1, so that the
    writer retries with twice the room."""
    sam = open(GOLDEN_SAMS[0], "rb").read()
    assert range_encode(sam, ref_names(sam), threads, cap=len(sam) // 4) \
        is None


def chunks_of(sam, n):
    """``sam`` cut at line starts into about ``n`` pieces."""
    lines = sam.splitlines(keepends=True)
    step = -(-len(lines) // n)
    return [b"".join(lines[i:i + step]) for i in range(0, len(lines), step)]


def bam_bytes(path, sam, threads, level, chunks):
    lines = sam.splitlines()
    header = [line.decode() for line in lines[:next(
        i for i, line in enumerate(lines) if not line.startswith(b"@"))]]
    body = b"".join(line + b"\n" for line in sam.splitlines()
                    if not line.startswith(b"@"))
    w = bam.BamWriter(str(path), threads=threads, level=level)
    w.write_header(header)
    for piece in chunks_of(body, chunks):
        w.write_sam_bytes(piece)
    w.close()
    return path.read_bytes(), w.bgzf


@pytest.fixture
def python_only(monkeypatch):
    """``bam._native`` as a library without the named entries gives it."""
    def without(*names):
        have = bam._native()._asdict()
        monkeypatch.setattr(bam, "_native", lambda: bam.Native(
            **{k: None if k in names else v for k, v in have.items()}))
    return without


# every golden's records at once, several times over: many blocks
ALL_SAM = b"".join(open(p, "rb").read() for p in GOLDEN_SAMS[4:7]) * 3


@pytest.mark.parametrize("missing", [("deflate",), ("encode",),
                                     ("encode", "deflate")])
@pytest.mark.parametrize("threads", (1, 4))
def test_bam_writer_falls_back_to_python(missing, threads, python_only,
                                         tmp_path):
    """Without a native entry the writer takes its Python twin, with the
    same bytes, and counts no native byte."""
    native()
    want, w = bam_bytes(tmp_path / "n.bam", ALL_SAM, threads, 1, 5)
    assert w.native_bytes > 10 * B
    assert w.native_bytes == w.deflated_bytes // B * B
    python_only(*missing)
    got, w = bam_bytes(tmp_path / "p.bam", ALL_SAM, threads, 1, 5)
    assert got == want
    assert w.native_bytes == (0 if "deflate" in missing
                              else w.deflated_bytes // B * B)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("level", (0, 6))
def test_bam_file_equals_the_python_path(level, threads, python_only,
                                         tmp_path):
    """The whole BAM, chunk by chunk, at other levels and thread
    counts."""
    native()
    want, _ = bam_bytes(tmp_path / "n.bam", ALL_SAM, threads, level, 3)
    python_only("encode", "deflate")
    assert bam_bytes(tmp_path / "p.bam", ALL_SAM, 1, level, 7)[0] == want


def test_library_builds_without_zlib(monkeypatch, tmp_path):
    """Where the probe finds no zlib, the library is built without
    native/bgzf.cpp, keeps the encoder, and the writer deflates in
    Python with the same bytes."""
    native()
    want, _ = bam_bytes(tmp_path / "n.bam", ALL_SAM, 4, 1, 5)
    monkeypatch.setattr(native_build, "_has_zlib", lambda out: False)
    monkeypatch.setattr(native_build, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native_build, "_LIB", None)
    lib = ctypes.CDLL(native_build.build(force=True))
    assert hasattr(lib, "dart_sam_to_bam_mt")
    assert not hasattr(lib, "dart_bgzf_deflate")
    bam._native.cache_clear()
    try:
        got = bam._native()
        assert got.encode is not None and got.deflate is None
        data, w = bam_bytes(tmp_path / "p.bam", ALL_SAM, 4, 1, 5)
    finally:
        monkeypatch.undo()
        bam._native.cache_clear()
    assert data == want and w.native_bytes == 0


def test_zlib_probe_finds_zlib_here(tmp_path):
    out = str(tmp_path / "probe")
    assert native_build._has_zlib(out)
    assert not os.path.exists(out)


def test_aligner_counts_its_bgzf_bytes(golden_dir, data_dir, tmp_path):
    """``run`` with -bo copies the writer's counters into its stats: the
    full blocks deflated natively, the short last one in Python; a SAM
    run frames none."""
    from dart_tpu_torch.aligner import DartAligner
    from dart_tpu_torch.config import DartConfig
    from dart_tpu_torch.index import load_index
    from dart_tpu_torch.ops.fm_torch import FMIndexTorch

    native()
    idx = load_index(str(golden_dir / "index" / "toy"))
    engine = FMIndexTorch(idx, device="cpu")
    stats = {}
    for fmt in (1, 0):
        cfg = DartConfig()
        cfg.read_files_1 = [str(data_dir / "pe_1.fq")]
        cfg.read_files_2 = [str(data_dir / "pe_2.fq")]
        cfg.max_mismatch = 5
        cfg.output_format = fmt
        cfg.output_file = str(tmp_path / f"out{fmt}")
        cfg.sj_file = str(tmp_path / f"tab{fmt}")
        cfg.silent = True
        a = DartAligner(idx, cfg, engine=engine)
        a.run()
        stats[fmt] = a.stats
    s = stats[1]
    assert s["output_bytes"] > B
    assert s["output_native_bytes"] == s["output_bytes"] // B * B
    assert stats[0]["output_bytes"] == stats[0]["output_native_bytes"] == 0
    reader = load_reader("output_native_pct")
    assert 0 < reader({"reads": 1, "stats": s}) < 100


def load_reader(metric):
    path = os.path.join(REPO, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_output_native_pct_reader():
    """The share of native bytes, and nothing where the program has no
    such key or framed no byte; BENCHMARK.json lists it for the BAM
    cell."""
    read = load_reader("output_native_pct")
    assert read({"reads": 9, "stats": {"output_bytes": 400,
                                       "output_native_bytes": 300}}) == 75.0
    assert read({"reads": 9, "stats": {"output_bytes": 0,
                                       "output_native_bytes": 0}}) is None
    assert read({"reads": 9, "stats": {"output_s": 1.0}}) is None
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {m["name"]: m for m in json.load(f)["per_layer"]}[
            "output_native_pct"]
    assert entry["moves"] == "reads_per_s"
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == ["chr21_pe_bam"]
